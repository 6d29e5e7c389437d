"""The exact continuous-time SMC' simulator and the demography presets.

Port of the numpy part of phlash_tpu/sim.py (:111-265).  The draws are the
same numpy `default_rng(seed)` calls in the same order, so a seed gives the
het matrix that phlash_tpu.sim gives, bit for bit, for the same model.
`simulate_hmm` (JAX random), scrm, stdpopsim and msprime are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from phlash_tpu_torch.convert import to_numpy
from phlash_tpu_torch.data import RawContig
from phlash_tpu_torch.size_history import DemographicModel, SizeHistory


def _inv_hazard(t_grid: np.ndarray, c: np.ndarray, t0: float, E: float, mult: float = 1.0,
                cap: float = np.inf) -> float:
    """Solve int_{t0}^{h} mult * c(s) ds = E for h, c piecewise constant.

    t_grid: (K,) epoch starts (t_grid[0] == 0), last epoch open.  Exact
    inversion of the piecewise-linear cumulative hazard.  If the solution
    would exceed `cap`, returns `cap` with the remaining hazard unspent (the
    caller reads h >= cap as "escaped past the cap").
    """
    k = int(np.searchsorted(t_grid, t0, side="right") - 1)
    h = t0
    while h < cap:
        end = min(t_grid[k + 1] if k + 1 < len(t_grid) else np.inf, cap)
        rate = mult * c[k]
        step = (end - h) * rate
        if E <= step or not np.isfinite(end):
            return min(h + E / rate, cap)
        E -= step
        h = end
        if h < cap:
            k += 1
    return cap


def simulate_smc_continuous(dm: DemographicModel, L: int, seed: int = 0, window_size: int = 100,
                            n_samples: int = 1) -> RawContig:
    """Simulate a diploid het sequence of L windows from the continuous SMC'
    process of `dm` (window-scaled theta and rho).

    The TMRCA path is piecewise constant between recombinations, which
    arrive at genome-distance rate 2 rho s; each detaches a lineage at
    height Uniform(0, s) that re-coalesces against hazard 2 c(h) below s
    (half of those rejoin its own branch and leave the TMRCA unchanged) and
    c(h) above it.  Het sites are a Poisson process at rate theta s a window,
    binned to windows.  Each of the n_samples rows is an independent path;
    with n_samples > 1 no AFS is emitted.
    """
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_samples):
        starts, tmrca = _segments_smc_continuous(dm, L, rng)
        lengths = np.diff(starts)

        # Poisson mutations at rate theta * s per window of genome distance
        n_mut = rng.poisson(float(dm.theta) * tmrca * lengths)
        total = int(n_mut.sum())
        obs = np.zeros(L, dtype=np.int8)
        if total:
            seg_of = np.repeat(np.arange(len(lengths)), n_mut)
            pos = starts[seg_of] + rng.random(total) * lengths[seg_of]
            obs[np.minimum(pos.astype(np.int64), L - 1)] = 1
        rows.append(obs)
    afs = np.ones(1) if n_samples == 1 else None
    return RawContig(het_matrix=np.stack(rows), afs=afs, window_size=window_size)


def _segments_smc_continuous(dm: DemographicModel, L: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """The TMRCA path of the continuous SMC' process over [0, L] windows:
    (starts, tmrca), len(starts) == len(tmrca) + 1, the path is tmrca[i] on
    [starts[i], starts[i+1]).  rng: a np.random.Generator or a seed."""
    if isinstance(rng, int):
        rng = np.random.default_rng(rng)
    t_grid = to_numpy(dm.eta.t).astype(np.float64)
    c = to_numpy(dm.eta.c).astype(np.float64)
    rho = float(dm.rho if dm.rho is not None else dm.theta)

    s = _inv_hazard(t_grid, c, 0.0, rng.standard_exponential())  # TMRCA ~ pi
    x = 0.0
    seg_starts, seg_tmrca = [0.0], [s]
    while True:
        # recombination events arrive at genome-distance rate 2 * rho * s
        x += rng.standard_exponential() / (2.0 * rho * s)
        if x >= L:
            break
        # detach a lineage at height Uniform(0, s); float it upward against
        # hazard 2c below s (two available partners), capping the draw at s
        u = rng.uniform(0.0, s)
        h = _inv_hazard(t_grid, c, u, rng.standard_exponential(), mult=2.0, cap=s)
        if h < s:
            # coalesced below s: half the events rejoin the original branch
            # (invisible: TMRCA unchanged), half hit the other branch
            if rng.random() < 0.5:
                s = h
            else:
                continue
        else:
            # floating above s: single partner left, hazard c(h)
            s = _inv_hazard(t_grid, c, s, rng.standard_exponential())
        seg_starts.append(x)
        seg_tmrca.append(s)
    seg_starts.append(float(L))
    return np.asarray(seg_starts), np.asarray(seg_tmrca)


# -- demography presets, float64 ----------------------------------------------


def constant_demography(theta: float = 1e-2, rho: float = None, M: int = 16) -> DemographicModel:
    return DemographicModel.default(pattern=f"{M}*1", theta=theta, rho=rho)


def _with_rates(base: DemographicModel, c: np.ndarray) -> DemographicModel:
    eta = SizeHistory(t=base.eta.t, c=torch.as_tensor(c, dtype=base.eta.t.dtype))
    return DemographicModel(eta=eta, theta=base.theta, rho=base.rho)


def zigzag_demography(theta: float = 1e-2, M: int = 16) -> DemographicModel:
    "A zigzag-style size history exercising sharp rate changes."
    base = DemographicModel.default(pattern=f"{M}*1", theta=theta)
    return _with_rates(base, np.exp(np.sin(np.linspace(0.0, 3.0 * np.pi, M)) * 1.5))


def bottleneck_demography(theta: float = 1e-2, M: int = 16) -> DemographicModel:
    base = DemographicModel.default(pattern=f"{M}*1", theta=theta)
    c = np.ones(M)
    c[M // 3: M // 2] = 10.0  # 10x higher coalescence = crash
    return _with_rates(base, c)
