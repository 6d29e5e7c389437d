"""The evaluation half of the port's SizeHistory against
phlash_tpu.size_history on random histories at float64: __call__ (batched
too), R, density, sf, cdf, mu, from_pmf, default and l2 at rtol 1e-12,
quantile and balance at 1e-8, tv at 1e-10 absolute, with its equal-rate
(isclose) and open-last-piece (U = inf) branches."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from phlash_tpu import size_history as jsh
from phlash_tpu_torch.size_history import SizeHistory, _tv_piece

RTOL = 1e-12


def _random(seed, M=8):
    "(t, c): t[0] == 0, increasing; c in (0.2, 3.2)."
    rng = np.random.default_rng(seed)
    t = np.concatenate([[0.0], np.cumsum(rng.exponential(0.4, M - 1))])
    return t, 0.2 + 3.0 * rng.random(M)


def _pair(seed, M=8):
    t, c = _random(seed, M)
    return (SizeHistory(t=torch.as_tensor(t), c=torch.as_tensor(c)),
            jsh.SizeHistory(t=jnp.asarray(t), c=jnp.asarray(c)))


def _points(t):
    "Points inside every epoch, on the breakpoints, and past the last one."
    return np.concatenate([np.linspace(0.0, 1.5 * t[-1], 37), t])


@pytest.mark.parametrize("Ne", [False, True])
def test_call_one_model_and_batched(Ne):
    """c(x) / Ne(x) of one model at a scalar and at a vector, and of a batch
    of 5 models at a shared vector and at per-model vectors, against
    phlash_tpu's model by model."""
    ours, theirs = _pair(0)
    x = _points(np.asarray(theirs.t))
    np.testing.assert_allclose(ours(x, Ne=Ne).numpy(), np.asarray(theirs(x, Ne=Ne)), rtol=RTOL)
    assert ours(0.7, Ne=Ne).shape == ()
    np.testing.assert_allclose(float(ours(0.7, Ne=Ne)), float(theirs(0.7, Ne=Ne)), rtol=RTOL)

    pairs = [_random(s) for s in range(5)]
    batch = SizeHistory(t=torch.as_tensor(np.stack([t for t, _ in pairs])),
                        c=torch.as_tensor(np.stack([c for _, c in pairs])))
    want = np.stack([np.asarray(jsh.SizeHistory(t=jnp.asarray(t), c=jnp.asarray(c))(x, Ne=Ne))
                     for t, c in pairs])
    got = batch(x, Ne=Ne)
    assert got.shape == (5, len(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    xs = np.stack([_points(t) for t, _ in pairs])
    want = np.stack([np.asarray(jsh.SizeHistory(t=jnp.asarray(t), c=jnp.asarray(c))(xi, Ne=Ne))
                     for (t, c), xi in zip(pairs, xs)])
    np.testing.assert_allclose(batch(xs, Ne=Ne).numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_hazard_density_sf_cdf_mu(seed):
    "R, density (with a rate multiplier), sf, cdf and mu against phlash_tpu."
    ours, theirs = _pair(seed)
    x = _points(np.asarray(theirs.t))
    for name, a, b in (("R", ours.R, theirs.R), ("density", ours.density(), theirs.density()),
                       ("density(c=3)", ours.density(3.0), theirs.density(3.0)),
                       ("sf", ours.sf, theirs.sf), ("cdf", ours.cdf, theirs.cdf)):
        np.testing.assert_allclose(a(x).numpy(), np.asarray(b(jnp.asarray(x))), rtol=RTOL,
                                   atol=1e-300, err_msg=name)
    np.testing.assert_allclose(float(ours.mu), float(theirs.mu), rtol=RTOL)
    np.testing.assert_allclose(ours.R.c.numpy(), np.asarray(theirs.R.c), rtol=RTOL)
    assert ours.K == theirs.K and ours.M == theirs.M
    np.testing.assert_allclose(ours.Ne.numpy(), np.asarray(theirs.Ne), rtol=RTOL)


def test_default_and_from_pmf():
    "default(K) and from_pmf(t, p) build the histories phlash_tpu builds."
    for K in (1, 5, 16):
        ours, theirs = SizeHistory.default(K), jsh.SizeHistory.default(K)
        np.testing.assert_allclose(ours.t.numpy(), np.asarray(theirs.t), rtol=RTOL)
        np.testing.assert_allclose(ours.c.numpy(), np.asarray(theirs.c), rtol=RTOL)
    t, _ = _random(3)
    p = np.random.default_rng(3).dirichlet(np.ones(len(t)))
    ours, theirs = SizeHistory.from_pmf(t, p), jsh.SizeHistory.from_pmf(t, p)
    np.testing.assert_allclose(ours.c.numpy(), np.asarray(theirs.c), rtol=RTOL)
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(theirs.t), rtol=RTOL)
    # the pmf is recovered on the finite epochs
    np.testing.assert_allclose(ours.p_coal().numpy()[1:-1], p[1:-1], rtol=1e-10)


def test_l2():
    "l2 on [0, t_max] between two random histories, t_max inside and past the grids."
    (a, ja), (b, jb) = _pair(4), _pair(5)
    for t_max in (0.9, 2.5, 40.0):
        np.testing.assert_allclose(float(a.l2(b, t_max)), float(ja.l2(jb, t_max)), rtol=RTOL)


@pytest.mark.parametrize("seed", [6, 7])
def test_quantile_and_balance(seed):
    "quantile(q) (scipy on the host) and balance() against phlash_tpu at 1e-8."
    ours, theirs = _pair(seed)
    for q in (0.0, 0.05, 0.5, 0.95, 0.999):
        np.testing.assert_allclose(ours.quantile(q), theirs.quantile(q), rtol=1e-8, atol=1e-12)
    ob, tb = ours.balance(), theirs.balance()
    np.testing.assert_allclose(ob.t.numpy(), np.asarray(tb.t), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(ob.c.numpy(), np.asarray(tb.c), rtol=1e-8)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("one,other", [((8, 8), (9, 6)), ((10, 8), (11, 6)), ((12, 8), (12, 8))])
def test_tv(one, other, n):
    """tv between random histories (seed, M) on different grids (0 for equal
    ones), 1e-10 absolute."""
    (a, ja), (b, jb) = _pair(*one), _pair(*other)
    got, want = float(a.tv(b, n)), float(ja.tv(jb, n))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    if one == other:
        assert got == 0.0


def test_tv_nearly_equal_rates():
    """Rates equal to 1e-9 relative on every piece take the isclose branch;
    the distance is ~1e-9, as phlash_tpu's, at 1e-10 absolute."""
    t, c = _random(13)
    a = SizeHistory(t=torch.as_tensor(t), c=torch.as_tensor(c))
    b = SizeHistory(t=torch.as_tensor(t), c=torch.as_tensor(c * (1 + 1e-9)))
    ja = jsh.SizeHistory(t=jnp.asarray(t), c=jnp.asarray(c))
    jb = jsh.SizeHistory(t=jnp.asarray(t), c=jnp.asarray(c * (1 + 1e-9)))
    got = float(a.tv(b))
    np.testing.assert_allclose(got, float(ja.tv(jb)), rtol=0, atol=1e-10)
    assert 0.0 <= got < 1e-7


def test_tv_piece_branches_and_quadrature():
    """_tv_piece per piece against phlash_tpu's, with crossing and
    non-crossing pairs, equal rates (the isclose branch) and open pieces
    (U = inf), and against quadrature of |f1 - f2|."""
    from scipy.integrate import quad

    a1 = np.array([1.0, 2.0, 0.5, 1.3, 1.3, 0.7, 2.0])
    b1 = np.array([0.1, 0.0, 0.3, 0.2, 0.2, 0.0, 0.4])
    a2 = np.array([2.0, 2.0 * (1 + 1e-7), 0.25, 1.3, 0.9, 1.4, 0.5])
    b2 = np.array([0.0, 0.1, 0.1, 0.5, 0.1, 0.2, 0.0])
    T = np.array([0.7, 1.5, np.inf, 2.0, np.inf, np.inf, 0.3])
    got = _tv_piece(*(torch.as_tensor(v) for v in (a1, b1, a2, b2, T))).numpy()
    want = np.asarray(jax.vmap(jsh._tv_piece, (1, 1, 0))(
        jnp.asarray(np.stack([a1, b1])), jnp.asarray(np.stack([a2, b2])), jnp.asarray(T)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for k in range(len(T)):
        f = lambda u: abs(a1[k] * np.exp(-(a1[k] * u + b1[k]))  # noqa: E731
                          - a2[k] * np.exp(-(a2[k] * u + b2[k])))
        np.testing.assert_allclose(got[k], quad(f, 0.0, T[k], limit=200)[0], rtol=1e-7,
                                   atol=1e-10)


def test_one_model_methods_refuse_a_batch():
    t, c = _random(14)
    batch = SizeHistory(t=torch.as_tensor(np.stack([t, t])), c=torch.as_tensor(np.stack([c, c])))
    for call in (lambda: batch.R, lambda: batch.mu, lambda: batch.tv(batch),
                 lambda: batch.quantile(0.5)):
        with pytest.raises(ValueError, match="one model"):
            call()
