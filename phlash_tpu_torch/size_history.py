"""Piecewise-constant coalescent size histories and demographic models.

Port of phlash_tpu/size_history.py:32-185,302-360 (the part the SVGD fit path
runs).  ``SizeHistory(t, c)`` holds breakpoints t (t[..., 0] == 0) and
per-epoch pair-coalescence rates c as tensors whose leading axes are batch
axes (one row per particle), so every method works on one model or on the
whole particle cloud at once.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from phlash_tpu_torch.utils import Pattern, texp_mean


def _append(x: torch.Tensor, value: float) -> torch.Tensor:
    "Append a constant along the last axis."
    return torch.cat([x, torch.full_like(x[..., :1], value)], -1)


@dataclass(frozen=True)
class SizeHistory:
    t: torch.Tensor  # (..., M) epoch start times, t[..., 0] == 0
    c: torch.Tensor  # (..., M) coalescence rate within each epoch

    @property
    def M(self) -> int:
        return self.t.shape[-1]

    def surv(self) -> torch.Tensor:
        "Survival function of the coalescence density at each breakpoint."
        hazard = torch.cumsum(self.c[..., :-1] * torch.diff(self.t), -1)
        return _append(torch.exp(-hazard), 0.0)

    def p_coal(self) -> torch.Tensor:
        "P(coalescence occurs within epoch k) for each epoch k."
        interior = -torch.diff(self.surv())
        return torch.cat([1.0 - interior.sum(-1, keepdim=True), interior], -1)

    @property
    def pi(self) -> torch.Tensor:
        "Alias for p_coal(): the prior over discretized TMRCA intervals."
        return self.p_coal()

    def ect(self) -> torch.Tensor:
        """Expected coalescence time conditional on coalescing in each epoch:
        t0 + dt * texp_mean(c * dt) in finite epochs, t_{M-1} + 1/c in the
        last (open) one."""
        t0, dt = self.t[..., :-1], torch.diff(self.t)
        inner = t0 + dt * texp_mean(self.c[..., :-1] * dt)
        e = torch.cat([inner, self.t[..., -1:] + 1.0 / self.c[..., -1:]], -1)
        return torch.clamp_min(e, 1e-20)

    def etjj(self, n: int) -> torch.Tensor:
        """E[time while exactly j lineages remain], j = 2..n: (..., n-1).

        Per epoch k at rate m*c_k over width dt_k from hazard m*H_k the
        contribution is exp(-m H_k) (1 - exp(-m c_k dt_k)) / (m c_k); the open
        last epoch contributes exp(-m H_last) / (m c_last)."""
        c, dt = self.c, torch.diff(self.t)
        haz = torch.cat(
            [torch.zeros_like(c[..., :1]), torch.cumsum(c[..., :-1] * dt, -1)], -1
        )  # (..., K)
        m = _pair_counts(n, c.dtype, c.device)  # (n-1,)
        mh = m[:, None] * haz[..., None, :]  # (..., n-1, K)
        finite = (
            torch.exp(-mh[..., :-1])
            * -torch.expm1(-m[:, None] * (c[..., :-1] * dt)[..., None, :])
            / (m[:, None] * c[..., None, :-1])
        )
        last = torch.exp(-mh[..., -1]) / (m * c[..., -1:])
        return finite.sum(-1) + last

    def etbl(self, n: int) -> torch.Tensor:
        """Expected total branch length subtending b = 1..n-1 leaves: the
        expected (unnormalized) site-frequency spectrum, (..., n-1)."""
        etjj = self.etjj(n)
        return etjj @ _W_tensor(n, etjj.dtype, etjj.device).T


def _psmc_time_grid(M: int, t_max: float = 15.0) -> np.ndarray:
    "Default discretization grid: 0 followed by geomspace(1e-3, t_max, M-1)."
    return np.concatenate([[0.0], np.geomspace(1e-3, t_max, M - 1)])


@dataclass(frozen=True)
class DemographicModel:
    eta: SizeHistory
    theta: float  # scaled mutation rate per window (one value for the cloud)
    rho: torch.Tensor | float  # scaled recombination rate per window, (...)

    @classmethod
    def default(cls, pattern: str, theta: float, rho: float = None, t_max: float = 15.0,
                dtype=torch.float64, device="cpu"):
        if rho is None:
            rho = theta
        M = Pattern(pattern).M
        t = torch.as_tensor(_psmc_time_grid(M, t_max), dtype=dtype, device=device)
        eta = SizeHistory(t=t, c=torch.ones_like(t))
        return cls(eta=eta, theta=theta, rho=torch.as_tensor(rho, dtype=dtype, device=device))

    def rescale(self, mu: float) -> "DemographicModel":
        """Convert from coalescent units to generations given the per-locus
        per-generation mutation rate mu."""
        N0 = (self.theta / 2.0) / mu
        eta = SizeHistory(t=N0 * self.eta.t, c=self.eta.c / N0)
        return DemographicModel(eta=eta, theta=mu, rho=self.rho / N0)


# The constants of etjj and etbl, built once per (n, dtype, device) and
# shared read-only: a step that rebuilt them would copy them from the host
# at every call, which costs host time and is not allowed in a CUDA graph
# capture.
@functools.lru_cache(maxsize=32)
def _pair_counts(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    "j (j - 1) / 2 for j = 2..n: the pair-coalescence rate multipliers, (n-1,)."
    j = np.arange(2, n + 1)
    return torch.as_tensor(j * (j - 1) // 2, dtype=dtype, device=device)


@functools.lru_cache(maxsize=32)
def _W_tensor(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    "_W_matrix(n) as a tensor."
    return torch.as_tensor(_W_matrix(n), dtype=dtype, device=device)


def _W_matrix(n: int) -> np.ndarray:
    """Polanski-Kimmel W matrix (Polanski & Kimmel 2003, eqs. 13-15).

    W[b-1, j-2] maps E[t_jj] (j = 2..n) to the expected total branch length
    subtending b = 1..n-1 leaves, run in exact rational arithmetic and cast
    to float64 once at the end.
    """
    if n == 1:
        return np.array([[]], dtype=np.float64)
    rows = []
    for b in range(1, n):
        w = [Fraction(6, n + 1)]  # j = 2
        if n >= 3:
            w.append(Fraction(30 * (n - 2 * b), (n + 1) * (n + 2)))  # j = 3
        for j in range(2, n - 1):  # recurrence emits column j + 2
            lead = Fraction(3 + 2 * j, j * (n + j + 1))
            w.append(lead * ((n - 2 * b) * w[-1] - Fraction((1 + j) * (n - j), 2 * j - 1) * w[-2]))
        rows.append([float(x) for x in w])
    return np.array(rows, dtype=np.float64)
