"""The transition's test oracles in phlash_tpu_torch (transition.expQ and
transition.q_s) against scipy and quadrature, and against phlash_tpu's."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
import scipy.integrate
import scipy.linalg

from phlash_tpu.size_history import DemographicModel as JDemographicModel
from phlash_tpu.transition import expQ as jax_expQ
from phlash_tpu.transition import q_s as jax_q_s
from phlash_tpu_torch import convert
from phlash_tpu_torch.transition import expQ, q_s


def _generator(r, c, n):
    return np.array([[-r, r, 0.0], [c, -(n * c), (n - 1) * c], [0.0, 0.0, 0.0]])


@pytest.mark.parametrize("n", [2, 3, 5])
def test_expQ_vs_scipy_expm_and_jax(n):
    """e^Q in closed form against scipy.linalg.expm (rtol 1e-8, atol 1e-12)
    on draws from a numpy seed, as a batch, and against phlash_tpu's expQ
    (1e-12)."""
    rng = np.random.default_rng(n)
    r, c = rng.uniform(0.01, 2.0, 6), rng.uniform(0.1, 3.0, 6)
    got = expQ(torch.as_tensor(r), torch.as_tensor(c), n)
    assert got.shape == (6, 3, 3) and got.dtype == torch.float64
    for k in range(6):
        want = scipy.linalg.expm(_generator(r[k], c[k], n))
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(expQ(float(r[k]), float(c[k]), n).numpy(),
                                   np.asarray(jax_expQ(r[k], c[k], n)), rtol=1e-12, atol=1e-15)


def test_expQ_small_u():
    "The series branch for a tiny eigenvalue gap: finite value and gradient, JAX's to 1e-12."
    r = torch.tensor(1e-9, dtype=torch.float64, requires_grad=True)
    g, = torch.autograd.grad(expQ(r, r / 2.0, 2)[0, 1], r)
    assert np.isfinite(float(g))
    want = jax.grad(lambda x: jax_expQ(x, x / 2.0, 2)[0, 1])(1e-9)
    np.testing.assert_allclose(float(g), float(want), rtol=1e-12)


def _dm():
    return JDemographicModel.default(pattern="16*1", theta=1e-2, rho=1e-2)


@pytest.mark.parametrize("r", [0.02, 1e-6])
def test_q_s_integrates_to_one(r):
    """q + atom integrates to 1 (rtol 1e-5): Gauss-Legendre quadrature
    (scipy.integrate.fixed_quad, 64 nodes) on each piece between the
    history's breakpoints and s, one vectorised call of q a piece, out to
    60 / min(c) past the last breakpoint."""
    dm = convert.from_reference_dm(_dm())
    s = 1.0
    q, atom = q_s(eta=dm.eta, s=s, r=r)
    t_hi = float(dm.eta.t[-1]) + 60.0 / float(dm.eta.c.min())
    edges = np.unique(np.concatenate([dm.eta.t.numpy(), [s, t_hi]]))
    edges = np.concatenate([edges[:-1], np.linspace(edges[-2], t_hi, 9)[1:]])
    total = sum(scipy.integrate.fixed_quad(lambda x: q(torch.as_tensor(x)).numpy(), a, b, n=64)[0]
                for a, b in zip(edges[:-1], edges[1:]))
    np.testing.assert_allclose(total + float(atom), 1.0, rtol=1e-5)


@pytest.mark.parametrize("r", [0.02, 1e-6])
def test_q_s_matches_jax(r):
    """q(t) on a grid of t on both sides of s and across the breakpoints,
    and the atom, against phlash_tpu's q_s: 1e-10."""
    jdm = _dm()
    dm = convert.from_reference_dm(jdm)
    s = 1.0
    t = np.concatenate([np.linspace(0.0, 2.5, 26), [1.0, 3.0, 7.5, 14.0, 20.0]])
    q, atom = q_s(eta=dm.eta, s=s, r=r)
    jq, jatom = jax_q_s(eta=jdm.eta, s=s, r=r)
    want = np.array([float(v) for v in jax.jit(jax.vmap(jq))(jnp.asarray(t))])
    got = q(torch.as_tensor(t))
    assert got.shape == t.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    np.testing.assert_allclose(float(atom), float(jatom), rtol=1e-10)
