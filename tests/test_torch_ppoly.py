"""The port's PPoly against phlash_tpu.ppoly.PPoly and
scipy.interpolate.PPoly at float64: values, antiderivative, derivative,
scale, and the closed-form exponential integral (finite at t = inf, in value
and gradient)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
from scipy.interpolate import PPoly as ScipyPPoly

from phlash_tpu.ppoly import PPoly as JaxPPoly
from phlash_tpu_torch.ppoly import PPoly

RTOL = 1e-12


def _case(seed, deg=2, K=6):
    "Breakpoints (K + 1,) from 0 and coefficients (deg + 1, K)."
    rng = np.random.default_rng(seed)
    x = np.concatenate([[0.0], np.cumsum(rng.random(K) + 0.1)])
    return x, rng.standard_normal((deg + 1, K))


def _ours(x, c):
    return PPoly(x=torch.as_tensor(x), c=torch.as_tensor(c))


def _points(x):
    "Points in every piece, on breakpoints and past the last one."
    return np.concatenate([np.linspace(0.0, x[-1] * 0.999, 41), x[:-1]])


@pytest.mark.parametrize("deg", [0, 1, 3])
def test_call_antiderivative_derivative_scale(deg):
    "Each method against scipy and phlash_tpu at rtol 1e-12."
    x, c = _case(deg, deg=deg)
    p, s, j = _ours(x, c), ScipyPPoly(c, x), JaxPPoly(x=jnp.asarray(x), c=jnp.asarray(c))
    t = _points(x)
    for ours, sp, jx in ((p, s, j), (p.antiderivative(), s.antiderivative(), j.antiderivative()),
                         (p.scale(2.5), ScipyPPoly(2.5 * c, x), j.scale(2.5))):
        got = ours(t).numpy()
        np.testing.assert_allclose(got, sp(t), rtol=RTOL, atol=1e-14)
        np.testing.assert_allclose(got, np.asarray(jx(jnp.asarray(t))), rtol=RTOL, atol=1e-14)
    if deg:
        np.testing.assert_allclose(p.derivative()(t).numpy(), s.derivative()(t), rtol=RTOL,
                                   atol=1e-14)
        np.testing.assert_allclose(p.derivative().c.numpy(), np.asarray(j.derivative().c),
                                   rtol=RTOL)
    np.testing.assert_allclose(p.antiderivative().c.numpy(), np.asarray(j.antiderivative().c),
                               rtol=RTOL, atol=1e-14)
    # a scalar point gives a 0-d tensor
    assert p(0.3).shape == () and float(p(0.3)) == pytest.approx(float(s(0.3)), rel=RTOL)


def _hazard(seed):
    "A piecewise-constant positive rate over breakpoints ending at +inf."
    rng = np.random.default_rng(seed)
    x = np.append(np.concatenate([[0.0], np.cumsum(rng.random(5) + 0.1)]), np.inf)
    return x, (rng.random(6) + 0.3)[None]


@pytest.mark.parametrize("t", [0.0, 0.37, 1.2, 2.9, 50.0, np.inf])
def test_exp_integral_matches_jax(t):
    "exp_integral(t, const) and its gradient in the rates against phlash_tpu, rtol 1e-12."
    x, c = _hazard(1)
    jp = lambda cc: JaxPPoly(x=jnp.asarray(x), c=cc).exp_integral(t, 0.3)  # noqa: E731
    want, g_want = jax.value_and_grad(jp)(jnp.asarray(c))
    rate = torch.tensor(c, requires_grad=True)
    got = PPoly(x=torch.as_tensor(x), c=rate).exp_integral(t, 0.3)
    (g,) = torch.autograd.grad(got, rate)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_want), rtol=RTOL, atol=1e-15)


def test_exp_integral_at_inf_is_finite_and_equals_quadrature():
    """At t = inf the value is the full integral of exp(-R) (checked by
    quadrature of the antiderivative) and the gradient, in the rates and in
    t itself, is finite: the finite branch is never NaN."""
    from scipy.integrate import quad

    x, c = _hazard(2)
    rate = torch.tensor(c, requires_grad=True)
    t = torch.tensor(np.inf, requires_grad=True)
    p = PPoly(x=torch.as_tensor(x), c=rate)
    v = p.exp_integral(t)
    g_rate, g_t = torch.autograd.grad(v, [rate, t])
    assert torch.isfinite(v) and torch.isfinite(g_rate).all() and torch.isfinite(g_t)
    R = PPoly(x=torch.as_tensor(x), c=torch.as_tensor(c)).antiderivative()
    want = quad(lambda u: np.exp(-float(R(u))), 0.0, np.inf, limit=200)[0]
    np.testing.assert_allclose(float(v.detach()), want, rtol=1e-8)


def test_exp_integral_refuses_a_polynomial():
    x, c = _case(3, deg=1)
    with pytest.raises(ValueError, match="piecewise-constant"):
        _ours(x, c).exp_integral()
