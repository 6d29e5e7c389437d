"""The model density and SVGD steps of phlash_tpu_torch against phlash_tpu,
float64, on identical particles, indices, warmup rows, data and AFS."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.flatten_util import ravel_pytree

from phlash_tpu.model import log_density_batched as jax_log_density
from phlash_tpu.model import log_prior as jax_log_prior
from phlash_tpu.ops.kernel_dense import DenseKernel
from phlash_tpu.svgd import SVGD as JaxSVGD
from phlash_tpu.svgd import svgd_direction as jax_svgd_direction
from phlash_tpu_torch import convert
from phlash_tpu_torch.model import log_density_batched, log_prior
from phlash_tpu_torch.ops.kernel_smc import SMCKernel
from phlash_tpu_torch.svgd import SVGD, AMSGrad, svgd_direction
from phlash_tpu_torch.training import batched_grad

OVERLAP, BODY, N_CHUNKS = 40, 120, 4
AFS = np.array([30.0, 10.0, 5.0])
C = (1.0, 2.0, 1.0)


@pytest.fixture(scope="module")
def chunks():
    rng = np.random.default_rng(2)
    d = rng.binomial(1, 0.05, size=(N_CHUNKS, OVERLAP + BODY)).astype(np.int8)
    d[1, 60:90] = -1
    return d


@pytest.fixture(scope="module")
def kernels(chunks):
    body = chunks[:, OVERLAP:]
    return DenseKernel(M=16, data=body, double_precision=True), SMCKernel(16, body)


def _particles(mcp, B, scale, seed):
    flat, unravel = ravel_pytree(mcp)
    rng = np.random.default_rng(seed)
    draws = np.asarray(flat)[None] + scale * rng.standard_normal((B, flat.shape[0]))
    return jax.vmap(unravel)(jnp.asarray(draws))


def _flat(jm):
    return np.asarray(jax.vmap(lambda m: ravel_pytree(m)[0])(jm))


@pytest.mark.parametrize("with_afs", [False, True])
def test_log_density_matches_jax(mcp, chunks, kernels, with_afs):
    """Values and per-particle gradients, dense backend on the JAX side.
    Without the AFS term: rtol 1e-10 (values) and 1e-8 (gradients).  With
    it: rtol 1e-6, because phlash_tpu evaluates the AFS term in float32 even
    in a float64 graph (model.py:125-138) while the port keeps the working
    dtype."""
    jkern, tkern = kernels
    inds = np.array([1, 3, 1])
    jm = _particles(mcp, 3, 0.2, seed=0)
    kw = dict(c=jnp.asarray(C), inds=jnp.asarray(inds),
              warmup=jnp.asarray(chunks[inds, :OVERLAP]), kern=jkern,
              afs=jnp.asarray(AFS) if with_afs else None)

    def total(P):
        v = jax_log_density(P, **kw)
        return v.sum(), v

    (_, want), want_g = jax.jit(jax.value_and_grad(total, has_aux=True))(jm)
    want, want_g = np.asarray(want), _flat(want_g)

    tm = convert.from_reference_mcmc(jm)
    tkw = dict(c=C, inds=torch.as_tensor(inds), warmup=torch.as_tensor(chunks[inds, :OVERLAP]),
               kern=tkern, afs=torch.as_tensor(AFS) if with_afs else None)
    got = log_density_batched(tm, **tkw)
    got_g = batched_grad(tm)(tm.flatten(), **tkw)
    rtol_v, rtol_g = (1e-6, 1e-6) if with_afs else (1e-10, 1e-8)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol_v)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=rtol_g,
                               atol=rtol_g * np.abs(want_g).max())


def test_log_prior_matches_jax(mcp):
    "The prior with the smoothness and ridge terms on: rtol 1e-12."
    import dataclasses

    m = dataclasses.replace(mcp, alpha=0.7, beta=0.05)
    jm = _particles(m, 4, 0.5, seed=1)
    want = np.asarray(jax.vmap(jax_log_prior)(jm))
    got = log_prior(convert.from_reference_mcmc(jm)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_svgd_direction_matches_jax():
    "Median-bandwidth RBF direction on identical particles and gradients."
    rng = np.random.default_rng(4)
    x, g = rng.standard_normal((7, 18)), rng.standard_normal((7, 18))
    want = np.asarray(jax_svgd_direction(jnp.asarray(x), jnp.asarray(g)))
    got = svgd_direction(torch.as_tensor(x), torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_three_svgd_steps_match_jax(mcp, chunks, kernels):
    """Three consecutive SVGD + amsgrad(0.1) steps with one fixed index
    sequence: JAX runs SVGD(jax.grad(...), optax.amsgrad(0.1),
    batched_grad=True) directly, the port SVGD(batched_grad, AMSGrad(0.1)).
    Particles agree to 1e-9."""
    jkern, tkern = kernels
    steps = [np.array([0, 2]), np.array([1, 3]), np.array([3, 3])]
    jm = _particles(mcp, 5, 0.3, seed=3)

    def density(P, **kw):
        return jax_log_density(P, kern=jkern, afs=None, **kw).sum()

    jsvgd = JaxSVGD(jax.grad(density), optax.amsgrad(0.1), batched_grad=True)
    jstep = jax.jit(lambda s, inds, warm: jsvgd.step(s, c=jnp.asarray(C), inds=inds, warmup=warm))
    jstate = jsvgd.init(jm)

    tm = convert.from_reference_mcmc(jm)
    tsvgd = SVGD(batched_grad(tm), AMSGrad(learning_rate=0.1))
    tstate = tsvgd.init(tm.flatten())
    for inds in steps:
        jstate = jstep(jstate, jnp.asarray(inds), jnp.asarray(chunks[inds, :OVERLAP]))
        tstate = tsvgd.step(tstate, c=C, inds=torch.as_tensor(inds),
                            warmup=torch.as_tensor(chunks[inds, :OVERLAP]), kern=tkern, afs=None)
        np.testing.assert_allclose(tstate.particles.numpy(), _flat(jstate.particles),
                                   rtol=1e-9, atol=1e-9)
    assert tstate.opt_state.count == 3
