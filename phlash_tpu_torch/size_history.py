"""Piecewise-constant coalescent size histories and demographic models.

Port of phlash_tpu/size_history.py:32-360.  ``SizeHistory(t, c)``
holds breakpoints t (t[..., 0] == 0) and per-epoch pair-coalescence rates c
as tensors whose leading axes are batch axes (one row per particle), so the
fit path's methods and `__call__` work on one model or on the whole particle
cloud at once.  The evaluation methods built on the hazard PPoly (`R`,
`density`, `sf`, `cdf`, `mu`, `quantile`, `balance`, `tv`, `l2`) take one
model: 1-D t and c.  `quantile` solves on the host with scipy, and `tv` and
`l2` build their union grids on the host, as phlash_tpu does.  `to_demes`,
`from_demography` and `draw` (one model too) exchange with demes and
msprime and plot with matplotlib, each an optional import.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable

import numpy as np
import torch

from phlash_tpu_torch.ppoly import PPoly
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

    @property
    def K(self) -> int:
        return self.c.shape[-1]

    @property
    def Ne(self) -> torch.Tensor:
        "Effective population size trajectory, Ne = 1 / (2c)."
        return 0.5 / self.c

    @classmethod
    def default(cls, K: int, dtype=torch.float64, device="cpu") -> "SizeHistory":
        "Constant history with breakpoints at Exponential(1) quantiles."
        q = np.linspace(0.0, 1.0, K, endpoint=False)
        t = torch.as_tensor(-np.log1p(-q), dtype=dtype, device=device)  # expon.ppf
        return cls(t=t, c=torch.ones_like(t))

    @classmethod
    def from_pmf(cls, t, p, dtype=torch.float64, device="cpu") -> "SizeHistory":
        """The history whose coalescence-time pmf over the grid t is p:
        p[i] = P(coalescence in [t[i], t[i+1])).  The rate of the last (open)
        epoch is unidentifiable and set to 1."""
        t, p = np.asarray(t), np.asarray(p)
        R, c = 0.0, []
        for dt, p_i in zip(np.diff(t), p[:-1]):
            c.append(-np.log1p(-p_i * np.exp(R)) / dt)
            R += c[-1] * dt
        c.append(1.0)
        as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
        return cls(t=as_t(t), c=as_t(c))

    def _one(self, what: str) -> None:
        if self.t.ndim != 1:
            raise ValueError(f"SizeHistory.{what} takes one model (1-D t and c), "
                             f"got t of shape {tuple(self.t.shape)}")

    # -- evaluation ---------------------------------------------------------
    def __call__(self, x, Ne: bool = False) -> torch.Tensor:
        """c(x), or Ne(x) with Ne=True, at the points x: a number or a 1-D
        tensor shared by every model of the batch, or a tensor (..., N) with
        the batch axes of t.  Returns the batch axes, then x's last axis."""
        x = torch.as_tensor(x, dtype=self.t.dtype, device=self.t.device)
        pts = x.reshape(1) if x.ndim == 0 else x
        edges = _append(self.t, math.inf)
        pts = pts.expand(*edges.shape[:-1], pts.shape[-1]).contiguous()
        j = torch.searchsorted(edges.contiguous(), pts, right=True) - 1
        c = self.c.expand(*pts.shape[:-1], self.K)
        out = torch.gather(c, -1, j.clamp(0, self.K - 1))
        out = out[..., 0] if x.ndim == 0 else out
        return 0.5 / out if Ne else out

    def to_pp(self) -> PPoly:
        self._one("to_pp")
        return PPoly(x=_append(self.t, math.inf), c=self.c[None])

    @property
    def R(self) -> PPoly:
        "Cumulative coalescent hazard R(t) = int_0^t c(s) ds."
        return self.to_pp().antiderivative()

    def density(self, c: float = 1.0) -> Callable:
        "Coalescence-time density (optionally with rate multiplier c)."
        R = self.R
        return lambda x: c * self(x) * torch.exp(-c * R(x))

    @property
    def sf(self) -> Callable:
        R = self.R
        return lambda x: torch.exp(-R(x))

    @property
    def cdf(self) -> Callable:
        R = self.R
        return lambda x: -torch.expm1(-R(x))

    @property
    def mu(self) -> torch.Tensor:
        "Unconditional expected pairwise coalescence time."
        return self.to_pp().exp_integral()

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

    # -- quantiles / metrics --------------------------------------------------
    def quantile(self, q: float) -> float:
        "Time at which the coalescence CDF reaches q (host-side root finding)."
        from scipy.optimize import root_scalar

        R = self.R

        def f(x):
            return -np.expm1(-float(R(x))) - q

        hi = float(self.t[-1]) or 1.0
        while f(hi) < 0:
            hi *= 2.0
        return root_scalar(f, bracket=(0.0, hi)).root

    def balance(self) -> "SizeHistory":
        "Re-grid so that each epoch carries equal coalescence mass."
        t = torch.as_tensor([self.quantile(q) for q in np.linspace(0, 1, self.K, endpoint=True)],
                            dtype=self.t.dtype, device=self.t.device)
        return SizeHistory(t=t, c=self(t))

    def _union(self, other: "SizeHistory", *extra: float) -> np.ndarray:
        "The sorted union of both grids (and `extra`), on the host."
        self._one("tv and l2")
        other._one("tv and l2")
        pts = set(self.t.tolist()) | set(other.t.tolist()) | set(extra)
        return np.array(sorted(pts))

    def tv(self, other: "SizeHistory", n: int = 1) -> torch.Tensor:
        """Total-variation distance between the two coalescence densities
        for n diploid samples."""
        n2 = 2 * n
        rate_mult = n2 * (n2 - 1) / 2.0
        t = torch.as_tensor(self._union(other), dtype=self.t.dtype, device=self.t.device)
        if float(t[0]) != 0.0:
            raise ValueError("SizeHistory.tv needs histories that start at t = 0")
        mids = _append((t[:-1] + t[1:]) / 2.0, float(t[-1]) + 1.0)
        R1 = SizeHistory(t=t, c=rate_mult * self(mids)).R
        R2 = SizeHistory(t=t, c=rate_mult * other(mids)).R
        return _tv_pwc(R1, R2)

    def l2(self, other: "SizeHistory", t_max: float) -> torch.Tensor:
        "L2 distance between the two Ne(t) trajectories on [0, t_max]."
        grid = self._union(other, float(t_max))
        grid = torch.as_tensor(grid[grid <= t_max], dtype=self.t.dtype, device=self.t.device)
        mid = (grid[:-1] + grid[1:]) / 2.0
        d2 = (self(mid, Ne=True) - other(mid, Ne=True)) ** 2 * torch.diff(grid)
        return torch.sqrt(d2.sum())

    # -- interop / plotting ---------------------------------------------------
    def to_demes(self, deme_name: str = "pop"):
        "Export as a demes.Graph of constant-size epochs (needs the optional `demes`)."
        import demes

        self._one("to_demes")
        b = demes.Builder()
        epochs = [dict(end_time=float(ti), start_size=float(Ne), end_size=float(Ne),
                       size_function="constant")
                  for ti, Ne in zip(self.t.tolist(), self.Ne.tolist())]
        b.add_deme(deme_name, epochs=epochs[::-1])
        return b.resolve()

    @classmethod
    def from_demography(cls, demo, dtype=torch.float64, device="cpu") -> "SizeHistory":
        """From a single-population msprime.Demography (needs the optional
        `msprime`): its size trajectory at every generation up to the last
        epoch start, kept where it changes."""
        import msprime

        assert isinstance(demo, msprime.Demography)
        if demo.num_populations > 1:
            raise ValueError("only single-population demographies are supported")
        dbg = demo.debug()
        t = np.arange(1 + dbg.epoch_start_time.max())
        Ne = dbg.population_size_trajectory(steps=t).squeeze()
        keep = np.insert(Ne[1:] != Ne[:-1], 0, True)
        as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
        return cls(t=as_t(t[keep]), c=as_t(1.0 / (2.0 * Ne[keep])))

    def draw(self, ax=None, density: bool = False, c: float = 1.0, **kwargs) -> None:
        "Plot Ne(t), or the coalescence density, on a matplotlib axis (default: the current one)."
        self._one("draw")
        if ax is None:
            import matplotlib.pyplot as plt

            ax = plt.gca()
        if density:
            x = np.geomspace(float(self.t[1]), 2.0 * float(self.t[-1]), 1000)
            ax.plot(x, self.density(c)(x).cpu().numpy(), **kwargs)
            return
        t, Ne = self.t.cpu().numpy(), self.Ne.cpu().numpy()
        kw = dict(kwargs)
        kw.update(label=None, marker=".")
        ax.scatter(t[-1:], Ne[-1:], **kw)
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.spines[["right", "top"]].set_visible(False)
        ax.set_xlabel("Generations")
        ax.set_ylabel("$N_e$")
        kwargs.setdefault("drawstyle", "steps-post")
        ax.plot(t, Ne, **kwargs)


def _tv_pwc(R1: PPoly, R2: PPoly) -> torch.Tensor:
    """TV distance between two densities a e^{-(a t + b)} given their
    piecewise-linear cumulative hazards (same breakpoints)."""
    return 0.5 * _tv_piece(R1.c[0], R1.c[1], R2.c[0], R2.c[1], torch.diff(R1.x)).sum()


def _tv_piece(a1, b1, a2, b2, T) -> torch.Tensor:
    "int_0^T |a1 e^{-(a1 t + b1)} - a2 e^{-(a2 t + b2)}| dt, exactly, per piece."

    def F(a, b, U):
        "int_0^U a e^{-(a t + b)} dt; valid at U = +inf for a > 0."
        return torch.exp(-b) * torch.where(torch.isinf(U), torch.ones_like(U),
                                           -torch.expm1(-a * U))

    same = torch.isclose(a1, a2)
    denom = torch.where(same, torch.ones_like(a1), a1 - a2)
    # the two densities cross at most once on the piece
    t_x = torch.minimum(torch.clamp_min((torch.log(a1 / a2) + b2 - b1) / denom, 0.0), T)
    t_x = torch.where(same, torch.zeros_like(t_x), t_x)
    f1, f2 = F(a1, b1, t_x), F(a2, b2, t_x)
    return torch.abs(f1 - f2) + torch.abs((F(a1, b1, T) - f1) - (F(a2, b2, T) - f2))


def _psmc_time_grid(M: int, t_max: float = 15.0) -> np.ndarray:
    "Default discretization grid: 0 followed by geomspace(1e-3, t_max, M-1)."
    return np.concatenate([[0.0], np.geomspace(1e-3, t_max, M - 1)])


@dataclass(frozen=True)
class DemographicModel:
    eta: SizeHistory
    theta: float  # scaled mutation rate per window (one value for the cloud)
    rho: torch.Tensor | float | None  # scaled recombination rate per window, (...)

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
        rho = None if self.rho is None else self.rho / N0
        return DemographicModel(eta=eta, theta=mu, rho=rho)

    @property
    def M(self) -> int:
        return self.eta.M


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
