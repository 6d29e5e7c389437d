"""The posterior comparison (phlash_tpu_torch.repro) against the evaluation
of tools/posterior_repro.py:259-296 run with phlash_tpu's SizeHistory, and
the committed phlash_tpu.fit ensembles that chip_smoke.py phase 6 holds the
port's fits against."""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np

from phlash_tpu import results as jresults
from phlash_tpu.sim import bottleneck_demography as jax_bottleneck
from phlash_tpu.size_history import SizeHistory as JSH
from phlash_tpu_torch import repro, results, sim

DATA = Path(__file__).resolve().parent / "data"
FIXTURES = ("torch_posterior_overlap500.npz", "torch_posterior_overlap0.npz")


def _ne_curves(t_knots, c_knots, grid):
    "tools/posterior_repro.py:181-187."
    out = []
    for t, c in zip(np.asarray(t_knots), np.asarray(c_knots)):
        idx = np.minimum(np.searchsorted(t, grid, side="right") - 1, len(c) - 1)
        out.append(1.0 / (2.0 * c[idx]))
    return np.stack(out)


def _reference_evaluation(ours, ref, truth):
    "tools/posterior_repro.py:259-296 on phlash_tpu's types."
    grid = np.geomspace(truth.eta.quantile(0.05), truth.eta.quantile(0.95), 64)
    ne_ref = _ne_curves(np.stack([m.eta.t for m in ref]), np.stack([m.eta.c for m in ref]), grid)
    ne_ours = np.stack([np.asarray(dm.eta(grid, Ne=True)) for dm in ours])
    qs = [0.025, 0.5, 0.975]
    lo_r, med_r, hi_r = np.quantile(ne_ref, qs, axis=0)
    lo_o, med_o, hi_o = np.quantile(ne_ours, qs, axis=0)
    tgrid = np.insert(grid, 0, 0.0)
    med_eta_r = JSH(t=tgrid, c=np.insert(1.0 / (2.0 * med_r), 0, 1.0 / (2.0 * med_r[0])))
    med_eta_o = JSH(t=tgrid, c=np.insert(1.0 / (2.0 * med_o), 0, 1.0 / (2.0 * med_o[0])))
    tv_cross = float(med_eta_o.tv(med_eta_r))
    cover_ours_in_ref = float(((med_o >= lo_r) & (med_o <= hi_r)).mean())
    cover_ref_in_ours = float(((med_r >= lo_o) & (med_r <= hi_o)).mean())
    return dict(
        tv_cross=tv_cross, tv_ref_truth=float(truth.eta.tv(med_eta_r)),
        tv_ours_truth=float(truth.eta.tv(med_eta_o)), cover_ours_in_ref=cover_ours_in_ref,
        cover_ref_in_ours=cover_ref_in_ours,
        med_log_gap=float(np.max(np.abs(np.log(med_o / med_r)))),
        ok=tv_cross <= 0.10 and cover_ours_in_ref >= 0.90 and cover_ref_in_ours >= 0.90,
    )


def _jax_cloud(models):
    "The same models as phlash_tpu types (its evaluation indexes numpy arrays)."
    from phlash_tpu.size_history import DemographicModel

    return [DemographicModel(eta=JSH(t=jnp.asarray(m.eta.t.numpy()),
                                     c=jnp.asarray(m.eta.c.numpy())), theta=m.theta, rho=m.rho)
            for m in models]


@pytest.fixture(scope="module")
def clouds():
    """The two committed clouds at float64: compare evaluates at float64,
    and phlash_tpu's SizeHistory keeps its inputs' dtype."""
    return [[type(m)(eta=type(m.eta)(t=m.eta.t.double(), c=m.eta.c.double()), theta=m.theta,
                     rho=m.rho) for m in results.load_posterior(str(DATA / name))]
            for name in FIXTURES]


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_compare_matches_reference_evaluation(clouds, order):
    """repro.compare on the two committed clouds, each way round, equals the
    evaluation of tools/posterior_repro.py at 1e-10; the two clouds were fit
    to different chunkings, so the gate reading must agree too."""
    ours, ref = clouds[order[0]], clouds[order[1]]
    got = repro.compare(ours, ref, sim.bottleneck_demography(theta=1e-2))
    want = _reference_evaluation(_jax_cloud(ours), _jax_cloud(ref), jax_bottleneck(theta=1e-2))
    for k, v in want.items():
        if k == "ok":
            assert got[k] == v
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-10, atol=1e-12, err_msg=k)
    assert got["tv_tol"] == 0.10 and got["cover_tol"] == 0.90


def test_compare_gates(clouds):
    "A cloud against itself passes at tv 0; against a cloud of 3x the sizes it fails."
    truth = sim.bottleneck_demography(theta=1e-2)
    same = repro.compare(clouds[0], clouds[0], truth)
    assert same["ok"] and same["tv_cross"] == 0.0 and same["cover_ours_in_ref"] == 1.0
    scaled = [type(m)(eta=type(m.eta)(t=m.eta.t, c=m.eta.c / 3.0), theta=m.theta, rho=m.rho)
              for m in clouds[0]]
    off = repro.compare(scaled, clouds[0], truth)
    assert not off["ok"] and off["med_log_gap"] == pytest.approx(np.log(3.0), rel=1e-6)


@pytest.mark.parametrize("which", [0, 1])
def test_planted_bias_readings(clouds, which):
    """scale_epochs scales c on PLANT_EPOCHS alone; a committed ensemble
    with each planted bias against itself reads a tv that grows with the
    factor, and the gates fail the largest (chip_smoke.py phase 6 requires
    this of the port's ensemble against phlash_tpu's)."""
    cloud, truth = clouds[which], sim.bottleneck_demography(theta=1e-2)
    f = repro.PLANT_FACTORS[-1]
    scaled = repro.scale_epochs(cloud, repro.PLANT_EPOCHS, f)
    ratio = torch.stack([s.eta.c / m.eta.c for s, m in zip(scaled, cloud)])
    want = torch.ones(16, dtype=ratio.dtype)
    want[repro.PLANT_EPOCHS] = f
    torch.testing.assert_close(ratio, want.expand_as(ratio), rtol=1e-6, atol=0)
    got = repro.planted(cloud, cloud, truth)
    assert list(got) == [str(x) for x in repro.PLANT_FACTORS]
    tvs = [r["tv_cross"] for r in got.values()]
    assert 0 < tvs[0] < tvs[1] < tvs[2]
    assert not got[str(f)]["ok"] and tvs[2] > repro.TV_TOL


@pytest.mark.parametrize("name", FIXTURES)
def test_committed_fixtures(name):
    """Each fixture loads in both packages: 16 fits (keys 7-22) of 48 finite
    particles of M = 16 epochs, pooled; its JSON records the options
    chip_smoke.py phase 6 fits with."""
    meta = json.loads((DATA / "torch_posterior_fixture.json").read_text())
    assert meta["L"] == 6_000_000 and meta["seeds"] == [0, 1]
    assert meta["keys"] == list(range(7, 23))
    assert meta["shared"]["num_particles"] == 48 and meta["shared"]["niter"] == 250
    P = 48 * len(meta["keys"])
    assert meta["fits"][name]["particles"] == P
    ours = results.load_posterior(str(DATA / name))
    theirs = jresults.load_posterior(str(DATA / name))
    assert len(ours) == len(theirs) == P
    for m in ours:
        assert m.eta.t.shape == m.eta.c.shape == (16,)
        assert torch.isfinite(m.eta.t).all() and (m.eta.c > 0).all() and np.isfinite(m.rho)
        assert float(m.eta.t[0]) == 0.0 and m.theta == pytest.approx(1e-4)
