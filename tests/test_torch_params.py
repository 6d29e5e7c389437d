"""Parameter assembly of phlash_tpu_torch against phlash_tpu (float64), and
the port's float32 assembly against its float64 one."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

from phlash_tpu.params import MCMCParams as JMCMCParams
from phlash_tpu.params import PSMCParams as JPSMCParams
from phlash_tpu.transition import transition_matrix as jax_transition
from phlash_tpu_torch import convert
from phlash_tpu_torch.params import PSMC_FIELDS, MCMCParams, PSMCParams
from phlash_tpu_torch.size_history import DemographicModel, SizeHistory
from phlash_tpu_torch.transition import transition_matrix

N_AFS = 10


def _jax_quantities(m):
    dm = m.to_dm()
    pp = JPSMCParams.from_dm(dm)
    out = dict(t=dm.eta.t, c=dm.eta.c, rho=dm.rho, ect=dm.eta.ect(), etbl=dm.eta.etbl(N_AFS),
               A=jax_transition(dm))
    out.update(pp._asdict())
    return out


def _torch_quantities(m: MCMCParams):
    dm = m.to_dm()
    pp = PSMCParams.from_dm(dm)
    out = dict(t=dm.eta.t, c=dm.eta.c, rho=dm.rho, ect=dm.eta.ect(), etbl=dm.eta.etbl(N_AFS),
               A=transition_matrix(dm))
    out.update({k: getattr(pp, k) for k in PSMC_FIELDS})
    return out


def _particles(mcp, kind):
    "The conftest particle, or a few random particles around it."
    flat, unravel = ravel_pytree(mcp)
    if kind == "fixture":
        draws = np.asarray(flat)[None]
    else:
        rng = np.random.default_rng(5)
        draws = np.asarray(flat)[None] + 0.5 * rng.standard_normal((4, flat.shape[0]))
    return jax.vmap(unravel)(jnp.asarray(draws))


@pytest.mark.parametrize("kind", ["fixture", "random"])
def test_assembly_matches_jax_f64(mcp, kind):
    "to_dm, ect, etbl, transition_matrix and PSMCParams.from_dm: rtol 1e-10."
    jm = _particles(mcp, kind)
    want = jax.jit(jax.vmap(_jax_quantities))(jm)
    tm = convert.from_reference_mcmc(jm)
    np.testing.assert_array_equal(tm.flatten().numpy(), np.asarray(jax.vmap(
        lambda m: ravel_pytree(m)[0])(jm)))
    got = _torch_quantities(tm)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-10, atol=0, err_msg=k)


def test_dm_fixture_matches_jax(dm, pp):
    "The conftest DemographicModel / PSMCParams through convert: rtol 1e-10."
    tdm = convert.from_reference_dm(dm)
    np.testing.assert_allclose(
        transition_matrix(tdm).numpy(), np.asarray(jax_transition(dm)), rtol=1e-10
    )
    got = convert.psmc_fields(PSMCParams.from_dm(tdm))
    want = convert.psmc_fields(convert.from_reference_psmc(pp))
    for k in PSMC_FIELDS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, err_msg=k)
    np.testing.assert_allclose(
        tdm.eta.etbl(N_AFS).numpy(), np.asarray(dm.eta.etbl(N_AFS)), rtol=1e-10
    )


def test_convert_round_trip(mcp, dm):
    "Port objects -> reference constructor fields -> port objects is exact."
    tm = convert.from_reference_mcmc(mcp)
    back = JMCMCParams(**convert.mcmc_fields(tm))
    np.testing.assert_array_equal(np.asarray(ravel_pytree(back)[0]), tm.flatten().numpy())
    assert (back.pattern, back.theta, back.alpha, back.beta) == (
        mcp.pattern, mcp.theta, mcp.alpha, mcp.beta)
    f = convert.dm_fields(convert.from_reference_dm(dm))
    np.testing.assert_array_equal(f["t"], np.asarray(dm.eta.t))
    np.testing.assert_array_equal(f["c"], np.asarray(dm.eta.c))
    assert f["theta"] == dm.theta and float(f["rho"]) == float(dm.rho)


def test_assembly_gradients_match_jax(mcp):
    """Gradient of a fixed random weighting of every assembled leaf (plus the
    expected SFS) w.r.t. the flat coordinates: rtol 1e-8."""
    jm = _particles(mcp, "random")
    rng = np.random.default_rng(9)
    names = list(PSMC_FIELDS) + ["etbl"]
    w = {k: rng.standard_normal((4, N_AFS - 1 if k == "etbl" else 16)) for k in names}

    def jax_loss(m):
        q = jax.vmap(_jax_quantities)(m)
        return sum((q[k] * w[k]).sum() for k in names)

    gj = jax.jit(jax.grad(jax_loss))(jm)
    want = np.asarray(jax.vmap(lambda g: ravel_pytree(g)[0])(gj))

    tm = convert.from_reference_mcmc(jm)
    flat = tm.flatten().requires_grad_(True)
    q = _torch_quantities(tm.unflatten(flat))
    loss = sum((q[k] * torch.as_tensor(w[k])).sum() for k in names)
    (got,) = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=0)


def test_assembly_f32_matches_f64():
    """The port's float32 assembly with torch's native transcendentals (no
    utils/accurate.py) reproduces float64 to 3e-5 relative on every entry
    above 1e-12, across realistic geometric grids, as
    tests/test_transition.py holds the JAX assembly."""
    rng = np.random.default_rng(11)
    worst = 0.0
    for _ in range(5):
        t1 = 10 ** rng.uniform(-5, -3)
        tM = 10 ** rng.uniform(0.5, 1.5)
        t = np.concatenate([[0.0], np.geomspace(t1, tM, 15)])
        cvals = 10 ** rng.uniform(-1.3, 1.3, 16)
        theta = 10 ** rng.uniform(-4, -1)
        rho = theta * 10 ** rng.uniform(-1, 1)

        def build(dtype):
            dm_ = DemographicModel(
                eta=SizeHistory(t=torch.tensor(t, dtype=dtype), c=torch.tensor(cvals, dtype=dtype)),
                theta=theta, rho=torch.tensor(rho, dtype=dtype),
            )
            return transition_matrix(dm_).double().numpy()

        A64, A32 = build(torch.float64), build(torch.float32)
        mask = A64 > 1e-12
        worst = max(worst, (np.abs(A32 - A64) / A64)[mask].max())
    assert worst < 3e-5, worst


def test_particle_assembly_f32_matches_f64(mcp):
    """Whole particles (coordinates -> PSMCParams) in float32 against float64:
    every transition and emission entry above 1e-12 to 1e-4 relative
    (float32 rounding of the coordinates themselves is ~6e-8 and is
    amplified by the exp/softplus chain and the transition's products).
    pi is held to 1e-6 absolute instead: its first entry is 1 - (sum of the
    others) in both packages (SizeHistory.p_coal), which loses ~1e-3 of its
    relative accuracy in float32 when it is ~1e-4."""
    tm = convert.from_reference_mcmc(_particles(mcp, "random"))
    p64 = PSMCParams.from_dm(tm.to_dm())
    p32 = PSMCParams.from_dm(tm.to(dtype=torch.float32).to_dm())
    for k in PSMC_FIELDS:
        a, b = getattr(p32, k).double().numpy(), getattr(p64, k).numpy()
        assert getattr(p32, k).dtype == torch.float32
        if k == "pi":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=k)
            continue
        mask = np.abs(b) > 1e-12
        np.testing.assert_allclose(a[mask], b[mask], rtol=1e-4, err_msg=k)
