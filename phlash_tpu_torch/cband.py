"""Simultaneous posterior confidence bands via mixed-integer programming.

Port of phlash_tpu/cband.py:21-105 onto the port's SizeHistory: the
narrowest band [l(t), u(t)] that holds at least `level` of the posterior's
Ne(t) paths at every grid point at once.  Minimize sum_k (u_k - l_k)
subject to big-M constraints that switch on a binary inclusion variable per
path, with sum_j z_j >= level * J, solved by scipy's HiGHS MILP on the host.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp

from phlash_tpu_torch.size_history import SizeHistory


def confidence_band(posterior: list, level: float = 0.95, num_points: int = 32,
                    log_scale: bool = True,
                    time_limit: float = 60.0) -> tuple[SizeHistory, SizeHistory]:
    """Simultaneous confidence band for the posterior Ne(t) trajectories.

    posterior: DemographicModel (or SizeHistory) samples; level: the
    simultaneous coverage; num_points: the time grid's size K (the MILP
    grows as K * J); log_scale: solve in log Ne (bands stay positive);
    time_limit: HiGHS's limit in seconds.  Returns (lower, upper) on the grid.
    """
    etas = [getattr(p, "eta", p) for p in posterior]
    J = len(etas)
    t_lo = np.quantile([float(e.t[1]) for e in etas], 0.025)
    t_hi = np.quantile([float(e.t[-1]) for e in etas], 0.975)
    t = np.geomspace(max(t_lo, 1e-8), t_hi, num_points)
    F = np.array([e(t, Ne=True).detach().cpu().numpy() for e in etas])  # (J, K)
    if log_scale:
        F = np.log(F)
    K = F.shape[1]

    # variables: [l_0..l_{K-1}, u_0..u_{K-1}, z_0..z_{J-1}]
    nvar = 2 * K + J
    cost = np.concatenate([-np.ones(K), np.ones(K), np.zeros(J)])

    lo_f, hi_f = F.min(), F.max()
    bigM = (hi_f - lo_f) + 1.0

    rows, cols, vals, lb, ub = [], [], [], [], []
    r = 0
    for j in range(J):
        for k in range(K):
            # F[j,k] - u_k <= M (1 - z_j)  ->  -u_k + M z_j <= M - F[j,k]
            rows += [r, r]
            cols += [K + k, 2 * K + j]
            vals += [-1.0, bigM]
            lb.append(-np.inf)
            ub.append(bigM - F[j, k])
            r += 1
            # l_k - F[j,k] <= M (1 - z_j)  ->  l_k + M z_j <= M + F[j,k]
            rows += [r, r]
            cols += [k, 2 * K + j]
            vals += [1.0, bigM]
            lb.append(-np.inf)
            ub.append(bigM + F[j, k])
            r += 1
    # coverage: sum_j z_j >= ceil(level * J)
    rows += [r] * J
    cols += list(range(2 * K, 2 * K + J))
    vals += [1.0] * J
    lb.append(float(np.ceil(level * J)))
    ub.append(np.inf)
    r += 1

    A = sparse.csr_matrix((vals, (rows, cols)), shape=(r, nvar))
    constraints = LinearConstraint(A, np.array(lb), np.array(ub))
    integrality = np.concatenate([np.zeros(2 * K), np.ones(J)])
    bounds_lo = np.concatenate([np.full(K, lo_f - 1), np.full(K, lo_f - 1), np.zeros(J)])
    bounds_hi = np.concatenate([np.full(K, hi_f + 1), np.full(K, hi_f + 1), np.ones(J)])
    res = milp(c=cost, constraints=constraints, integrality=integrality,
               bounds=Bounds(bounds_lo, bounds_hi), options=dict(time_limit=time_limit))
    if not res.success:
        raise RuntimeError(f"confidence band MILP failed: {res.message}")
    l_band, u_band = res.x[:K], res.x[K: 2 * K]
    if log_scale:
        l_band, u_band = np.exp(l_band), np.exp(u_band)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    return (SizeHistory(t=as_t(t), c=as_t(1.0 / (2.0 * l_band))),
            SizeHistory(t=as_t(t), c=as_t(1.0 / (2.0 * u_band))))
