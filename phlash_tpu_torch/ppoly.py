"""Piecewise polynomials (a scipy.interpolate.PPoly work-alike) in PyTorch.

Port of phlash_tpu/ppoly.py:24-91.  Underlies the cumulative coalescent
hazard R(t) of size_history.SizeHistory and the closed-form exponential
integral of its expected coalescence time.  One polynomial, not a batch:

    p(t) = sum_i c[i, j] * (t - x[j]) ** (deg - i)   for x[j] <= t < x[j+1],

with c (deg + 1, K) stored highest degree first, as numpy.polyval and
scipy.interpolate.PPoly have it, and x (K + 1,) breakpoints whose last entry
may be +inf.  A point outside [x[0], x[K]) takes the nearest piece.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def _polyval(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    "Horner's rule over the leading axis of c (highest degree first)."
    out = c[0] * torch.ones_like(x)
    for ci in c[1:]:
        out = out * x + ci
    return out


@dataclass(frozen=True)
class PPoly:
    x: torch.Tensor  # (K + 1,) breakpoints; the last may be +inf
    c: torch.Tensor  # (deg + 1, K) coefficients, highest power first

    def scale(self, a) -> "PPoly":
        "The polynomial times a constant."
        return PPoly(x=self.x, c=self.c * a)

    def _piece(self, t: torch.Tensor) -> torch.Tensor:
        "Index of the piece that holds t, clamped to [0, K - 1]."
        j = torch.searchsorted(self.x, t.reshape(-1).contiguous(), right=True) - 1
        return j.clamp(0, self.c.shape[1] - 1).reshape(t.shape)

    def __call__(self, t) -> torch.Tensor:
        "p(t); t a number or a tensor of any shape."
        t = torch.as_tensor(t, dtype=self.x.dtype, device=self.x.device)
        j = self._piece(t)
        return _polyval(self.c[:, j], t - self.x[j])

    def antiderivative(self) -> "PPoly":
        "The indefinite integral, continuous across breakpoints and 0 at x[0]."
        deg = self.c.shape[0] - 1
        powers = torch.arange(deg + 1, 0, -1, dtype=self.c.dtype, device=self.c.device)
        ci = self.c / powers[:, None]  # without the constant term
        # each integrated piece's value at its right end carries into the next
        ends = _polyval(torch.cat([ci, torch.zeros_like(ci[:1])])[:, :-1], torch.diff(self.x)[:-1])
        offsets = torch.cumsum(torch.cat([ends.new_zeros(1), ends]), 0)
        return PPoly(x=self.x, c=torch.cat([ci, offsets[None]]))

    def derivative(self) -> "PPoly":
        deg = self.c.shape[0] - 1
        powers = torch.arange(deg, 0, -1, dtype=self.c.dtype, device=self.c.device)
        return PPoly(x=self.x, c=self.c[:-1] * powers[:, None])

    def exp_integral(self, t=math.inf, const: float = 0.0) -> torch.Tensor:
        r"""\int_0^t e^{-R(u) + const} du with R(u) = \int_0^u p(s) ds, in
        closed form, for a piecewise-constant p.  The last (possibly
        infinite) piece is integrated analytically, and t = inf takes a
        separate branch, so value and gradient stay finite there."""
        if self.c.shape[0] != 1:
            raise ValueError("exp_integral needs a piecewise-constant polynomial")
        rate = self.c[0]
        dt = torch.diff(self.x)[:-1]
        haz = torch.cat([rate.new_zeros(1), torch.cumsum(rate[:-1] * dt, 0)])
        per_epoch = torch.cat([
            torch.exp(-haz[:-1] + const) * -torch.expm1(-rate[:-1] * dt) / rate[:-1],
            torch.exp(-haz[-1:] + const) / rate[-1:],
        ])
        t = torch.as_tensor(t, dtype=rate.dtype, device=rate.device)
        # both branches are evaluated: the finite one at t = 0 when t = inf,
        # because 0 * nan would poison the gradient
        finite = torch.isfinite(t)
        t_safe = torch.where(finite, t, torch.zeros_like(t))
        j = self._piece(t_safe)
        tail = torch.exp(-haz[j] + const) * -torch.expm1(-rate[j] * (t_safe - self.x[j])) / rate[j]
        full = (per_epoch * (torch.arange(len(rate), device=rate.device) < j)).sum()
        return torch.where(finite, full + tail, per_epoch.sum())
