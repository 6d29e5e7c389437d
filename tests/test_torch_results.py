"""Posterior files and confidence bands: a posterior saved by either
package loads in the other with equal values, and the port's
confidence_band equals phlash_tpu.cband.confidence_band on one cloud."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp
import numpy as np

from phlash_tpu import results as jresults
from phlash_tpu.cband import confidence_band as jax_confidence_band
from phlash_tpu.size_history import DemographicModel as JDM
from phlash_tpu.size_history import SizeHistory as JSH
import phlash_tpu_torch
from phlash_tpu_torch import results
from phlash_tpu_torch.size_history import DemographicModel, SizeHistory


def _cloud(P=16, M=16, seed=0):
    "(t, c, theta, rho) of P models on a common geometric grid with jittered rates."
    rng = np.random.default_rng(seed)
    t = np.concatenate([[0.0], np.geomspace(1e-3, 15.0, M - 1)])
    t = np.broadcast_to(t, (P, M)) * (1 + 0.05 * rng.random((P, 1)))
    t[:, 0] = 0.0
    c = np.exp(rng.standard_normal((P, M)) * 0.3 + np.sin(np.linspace(0, 3, M)))
    return t, c, 1e-4 * (1 + 0.1 * rng.random(P)), 1e-4 * (1 + 0.1 * rng.random(P))


def _ours(t, c, theta, rho):
    return [DemographicModel(eta=SizeHistory(t=torch.as_tensor(ti), c=torch.as_tensor(ci)),
                             theta=float(th), rho=None if r is None else float(r))
            for ti, ci, th, r in zip(t, c, theta, rho)]


def _theirs(t, c, theta, rho):
    return [JDM(eta=JSH(t=jnp.asarray(ti), c=jnp.asarray(ci)), theta=float(th),
                rho=None if r is None else float(r))
            for ti, ci, th, r in zip(t, c, theta, rho)]


def _check_equal(loaded, t, c, theta, rho):
    assert len(loaded) == len(t)
    for dm, ti, ci, th, r in zip(loaded, t, c, theta, rho):
        np.testing.assert_array_equal(np.asarray(dm.eta.t), ti)
        np.testing.assert_array_equal(np.asarray(dm.eta.c), ci)
        assert float(dm.theta) == th
        assert (dm.rho is None) if r is None else float(dm.rho) == r


@pytest.mark.parametrize("with_rho", [True, False])
def test_posterior_files_cross_load(tmp_path, with_rho):
    """save_posterior of each package, load_posterior of the other (and its
    own): the same t, c, theta and rho (None where a model has none)."""
    t, c, theta, rho = _cloud()
    rho = list(rho) if with_rho else [None] * len(t)
    results.save_posterior(str(tmp_path / "ours.npz"), _ours(t, c, theta, rho))
    jresults.save_posterior(str(tmp_path / "theirs.npz"), _theirs(t, c, theta, rho))
    for path in ("ours.npz", "theirs.npz"):
        _check_equal(results.load_posterior(str(tmp_path / path)), t, c, theta, rho)
        _check_equal(jresults.load_posterior(str(tmp_path / path)), t, c, theta, rho)
    with np.load(tmp_path / "ours.npz") as a, np.load(tmp_path / "theirs.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["c", "rho", "t", "theta"]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    loaded = phlash_tpu_torch.load_posterior(str(tmp_path / "theirs.npz"))
    assert isinstance(loaded[0], phlash_tpu_torch.DemographicModel)
    assert loaded[0].eta.t.dtype == torch.float64


def test_confidence_band_matches_jax():
    """The port's confidence_band on a 16-particle cloud (its MILP on scipy's
    HiGHS) equals phlash_tpu's at 1e-6 relative, lower <= upper, and returns
    the port's SizeHistory pair."""
    t, c, theta, rho = _cloud(P=16, seed=1)
    lo, hi = phlash_tpu_torch.confidence_band(_ours(t, c, theta, rho), num_points=12)
    jlo, jhi = jax_confidence_band(_theirs(t, c, theta, rho), num_points=12)
    assert isinstance(lo, SizeHistory) and isinstance(hi, SizeHistory)
    for ours, theirs in ((lo, jlo), (hi, jhi)):
        np.testing.assert_allclose(ours.t.numpy(), np.asarray(theirs.t), rtol=1e-12)
        np.testing.assert_allclose(ours.c.numpy(), np.asarray(theirs.c), rtol=1e-6)
    assert (lo.Ne <= hi.Ne * (1 + 1e-9)).all()
