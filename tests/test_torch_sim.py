"""The port's continuous SMC' simulator and demography presets against
phlash_tpu.sim: the same seed gives the same het matrix bit for bit."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np

from phlash_tpu import sim as jsim
from phlash_tpu_torch import sim
from phlash_tpu_torch.data import RawContig

L = 200_000


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_smc_continuous_bitwise(seed):
    """simulate_smc_continuous and _segments_smc_continuous on the
    bottleneck preset at L = 200,000 windows: bitwise equal to phlash_tpu's."""
    ours_dm, theirs_dm = sim.bottleneck_demography(theta=1e-2), jsim.bottleneck_demography(1e-2)
    ours = sim.simulate_smc_continuous(ours_dm, L=L, seed=seed, n_samples=1)
    theirs = jsim.simulate_smc_continuous(theirs_dm, L=L, seed=seed, n_samples=1)
    assert isinstance(ours, RawContig) and ours.window_size == theirs.window_size == 100
    assert ours.het_matrix.dtype == np.int8 and ours.het_matrix.shape == (1, L)
    np.testing.assert_array_equal(ours.het_matrix, theirs.het_matrix)
    np.testing.assert_array_equal(ours.afs, theirs.afs)
    assert 0 < ours.het_matrix.sum() < L
    for a, b in zip(sim._segments_smc_continuous(ours_dm, L, seed),
                    jsim._segments_smc_continuous(theirs_dm, L, seed)):
        np.testing.assert_array_equal(a, b)


def test_several_samples_and_zigzag_bitwise():
    "Three samples (no AFS) from the zigzag preset: the same het matrix as phlash_tpu's."
    ours = sim.simulate_smc_continuous(sim.zigzag_demography(), L=20_000, seed=5, n_samples=3)
    # phlash_tpu's zigzag rates go through XLA's sin; feed it the port's model
    # so that the draws see identical rates
    theirs = jsim.simulate_smc_continuous(sim.zigzag_demography(), L=20_000, seed=5, n_samples=3)
    assert ours.afs is None and theirs.afs is None
    np.testing.assert_array_equal(ours.het_matrix, theirs.het_matrix)


def test_presets():
    """constant and bottleneck equal phlash_tpu's in t and c bit for bit,
    zigzag at rtol 1e-14 (its sin comes from numpy here, from XLA there);
    all float64, with the same theta and rho."""
    for name, kw in (("constant_demography", dict(theta=2e-2, rho=1e-2)),
                     ("bottleneck_demography", dict(theta=1e-2)),
                     ("zigzag_demography", dict(theta=1e-2, M=12))):
        ours, theirs = getattr(sim, name)(**kw), getattr(jsim, name)(**kw)
        assert ours.eta.t.dtype == ours.eta.c.dtype == torch.float64
        assert ours.theta == theirs.theta and float(ours.rho) == float(theirs.rho)
        np.testing.assert_array_equal(ours.eta.t.numpy(), np.asarray(theirs.eta.t))
        if name == "zigzag_demography":
            np.testing.assert_allclose(ours.eta.c.numpy(), np.asarray(theirs.eta.c), rtol=1e-14)
        else:
            np.testing.assert_array_equal(ours.eta.c.numpy(), np.asarray(theirs.eta.c))


def test_inv_hazard():
    "_inv_hazard inverts the cumulative hazard exactly, and stops at its cap."
    t = np.array([0.0, 0.5, 1.0, 2.0])
    c = np.array([1.0, 2.0, 0.5, 4.0])
    for t0, E, mult in ((0.0, 0.3, 1.0), (0.2, 1.7, 1.0), (0.7, 2.0, 2.0), (1.5, 9.0, 1.0)):
        h = sim._inv_hazard(t, c, t0, E, mult)
        assert h == jsim._inv_hazard(t, c, t0, E, mult)
        grid = np.linspace(t0, h, 200_001)
        k = np.searchsorted(t, grid, side="right") - 1
        np.testing.assert_allclose(np.trapezoid(mult * c[k], grid), E, rtol=1e-4)
    assert sim._inv_hazard(t, c, 0.0, 100.0, cap=1.2) == 1.2
