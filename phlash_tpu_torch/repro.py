"""Posterior comparison: is one posterior cloud a reproduction of another?

The evaluation of tools/posterior_repro.py:181-313 on the port's types.  On a
64-point geometric grid between the truth's 5% and 95% coalescence-time
quantiles, each cloud's Ne(t) paths give the pointwise 2.5 / 50 / 97.5%
quantiles; each median, extended back to t = 0, is a SizeHistory.  The gates
(the North star's): the total-variation distance between the two medians'
coalescence densities is at most TV_TOL, and each median lies inside the
other cloud's 95% band on at least COVER_TOL of the grid.  A cloud that
pools several fits has a band that holds the spread between them, so on
pooled clouds coverage is the weaker half of the gate.  `compare`
returns a dict shaped like POSTERIOR_REPRO.json, "ours" being the first
cloud and "ref" the second.
"""

from __future__ import annotations

import numpy as np
import torch

from phlash_tpu_torch.size_history import DemographicModel, SizeHistory

TV_TOL = 0.10
COVER_TOL = 0.90
GRID_POINTS = 64
# planted biases whose gate readings chip_smoke.py phase 6 and
# tools/torch_posterior_spread.py print: c of these epochs (t from 0.03 to
# 0.5 coalescent units at the fixture's grid, 60% of the compared grid's
# log span) times each factor; the gates must catch the largest
PLANT_EPOCHS, PLANT_FACTORS = slice(5, 9), (1.2, 1.5, 2.0)


def _stack(models: list[DemographicModel], what: str) -> torch.Tensor:
    return torch.stack([getattr(m.eta, what).detach().cpu().double() for m in models])


def ne_curves(models: list[DemographicModel], grid: np.ndarray) -> np.ndarray:
    "Ne(t) of each model on `grid`: (P, len(grid))."
    eta = SizeHistory(t=_stack(models, "t"), c=_stack(models, "c"))
    return eta(torch.as_tensor(grid, dtype=torch.float64), Ne=True).numpy()


def median_history(med: np.ndarray, grid: np.ndarray) -> SizeHistory:
    "The median Ne(t) on `grid` as a SizeHistory, its first epoch extended back to 0."
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    return SizeHistory(t=as_t(np.insert(grid, 0, 0.0)),
                       c=as_t(np.insert(1.0 / (2.0 * med), 0, 1.0 / (2.0 * med[0]))))


def scale_epochs(models: list[DemographicModel], epochs: slice, factor: float
                 ) -> list[DemographicModel]:
    """The models with the coalescence rate c of `epochs` multiplied by
    `factor` (sizes divided by it): a planted bias, to read what the gates
    catch."""
    out = []
    for m in models:
        c = m.eta.c.clone()
        c[epochs] *= factor
        out.append(DemographicModel(eta=SizeHistory(t=m.eta.t, c=c), theta=m.theta, rho=m.rho))
    return out


def planted(ours: list[DemographicModel], ref: list[DemographicModel],
            truth: DemographicModel) -> dict:
    """The gates' reading on `ours` with each planted bias (PLANT_FACTORS on
    PLANT_EPOCHS) against `ref`: str(factor) -> tv_cross, the smaller of the
    two coverages, ok."""
    out = {}
    for f in PLANT_FACTORS:
        r = compare(scale_epochs(ours, PLANT_EPOCHS, f), ref, truth)
        out[str(f)] = dict(tv_cross=r["tv_cross"], ok=r["ok"],
                           cover=min(r["cover_ours_in_ref"], r["cover_ref_in_ours"]))
    return out


def compare(ours: list[DemographicModel], ref: list[DemographicModel],
            truth: DemographicModel) -> dict:
    """The two clouds' medians and 95% bands against each other (and each
    median against the truth): tv_cross, tv_ref_truth, tv_ours_truth,
    cover_ours_in_ref, cover_ref_in_ours, med_log_gap (the largest
    |log Ne ratio| of the medians), the gates tv_tol and cover_tol, and ok:
    both gates met."""
    grid = np.geomspace(truth.eta.quantile(0.05), truth.eta.quantile(0.95), GRID_POINTS)
    qs = [0.025, 0.5, 0.975]
    lo_r, med_r, hi_r = np.quantile(ne_curves(ref, grid), qs, axis=0)
    lo_o, med_o, hi_o = np.quantile(ne_curves(ours, grid), qs, axis=0)
    med_eta_r, med_eta_o = median_history(med_r, grid), median_history(med_o, grid)
    tv_cross = float(med_eta_o.tv(med_eta_r))
    cover_ours_in_ref = float(((med_o >= lo_r) & (med_o <= hi_r)).mean())
    cover_ref_in_ours = float(((med_r >= lo_o) & (med_r <= hi_o)).mean())
    return dict(
        tv_cross=tv_cross,
        tv_ref_truth=float(truth.eta.tv(med_eta_r)),
        tv_ours_truth=float(truth.eta.tv(med_eta_o)),
        cover_ours_in_ref=cover_ours_in_ref,
        cover_ref_in_ours=cover_ref_in_ours,
        med_log_gap=float(np.max(np.abs(np.log(med_o / med_r)))),
        tv_tol=TV_TOL,
        cover_tol=COVER_TOL,
        ok=tv_cross <= TV_TOL and cover_ours_in_ref >= COVER_TOL
        and cover_ref_in_ours >= COVER_TOL,
    )
