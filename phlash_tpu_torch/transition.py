"""SMC' discretized transition matrix over TMRCA intervals.

Port of phlash_tpu/transition.py:70-250: `_expQ2` (the 2x2 live block of the
3-state SMC' chain's e^Q with stable absorption probabilities) and
`transition_matrix`.  Leading axes are batch axes.  The JAX package composes
the 2x2 blocks with an associative scan; only row 0 of the running product
is ever read, so the port propagates that row sequentially over the 2M - 1
sub-intervals (the same products, associated left to right).

The assembled matrix has the compressed structure the HMM kernels use:
    A[i, j] = b[j]           for i > j
    A[j, j] = d[j]
    A[i, j] = u[i] * v[j]    for i < j
"""

from __future__ import annotations

import torch

from phlash_tpu_torch.size_history import DemographicModel, _append
from phlash_tpu_torch.utils import texp_mean


def _expQ2(r: torch.Tensor, c: torch.Tensor, n: int):
    """The 2x2 live block of e^Q plus stable per-row absorption.

    Returns ((p00, p01, p10, p11), p02, p12), elementwise over r and c.  No
    near-1 values are subtracted, so the tiny absorption probabilities keep
    their relative accuracy in float32 (see the JAX docstring for the
    derivation of each branch).
    """
    u = torch.sqrt((c * n) ** 2 - 2.0 * c * (n - 2) * r + r**2) / 2.0
    v = (r + c * n) / 2.0
    w = (r - c * n) / 2.0
    ab = c * r * (n - 1)  # == -(u^2 - v^2), exact
    upv = u + v
    one = torch.ones_like(u)
    a = -ab / torch.where(upv == 0.0, one, upv)
    b = -upv
    ea, eb = torch.expm1(a), torch.expm1(b)

    tiny = u < 1e-6
    u_ok = torch.where(tiny, one, u)
    exp_a, exp_b = torch.exp(a), torch.exp(b)
    shu = torch.where(tiny, torch.exp(-v) * (1.0 + u_ok**2 / 6.0), (ea - eb) / (2.0 * u_ok))
    big_raw = u + torch.abs(w)
    big = torch.where(big_raw == 0.0, one, big_raw)
    small = c * r / big
    s_plus = torch.where(w <= 0, small, big)  # u + w
    s_minus = torch.where(w <= 0, big, small)  # u - w
    p00 = torch.where(
        tiny, torch.exp(-v) * (1.0 - w), (exp_a * s_minus + exp_b * s_plus) / (2.0 * u_ok)
    )
    p11 = torch.where(
        tiny, torch.exp(-v) * (1.0 + w), (exp_a * s_plus + exp_b * s_minus) / (2.0 * u_ok)
    )
    P2 = (p00, r * shu, c * shu, p11)

    # row 0 absorption: the exact series where both exponents are small
    generic0 = (b * ea - a * eb) / (2.0 * u_ok)
    series, h, bp, fact = 0.0, one, one, 2.0
    for k in range(2, 8):  # truncation error O(scale^6 / 8!)
        series = series + h / fact
        bp = bp * b
        h = a * h + bp
        fact = fact * (k + 1)
    p02 = torch.where(torch.maximum(torch.abs(a), torch.abs(b)) < 0.05, ab * series, generic0)

    # row 1 absorption
    kappa = c + w
    generic1 = -((u_ok + kappa) * ea + (u_ok - kappa) * eb) / (2.0 * u_ok)
    limit1 = -(torch.expm1(-v) + kappa * torch.exp(-v))  # u -> 0
    p12 = torch.where(tiny, limit1, generic1)
    return P2, p02, p12


def transition_matrix(dm: DemographicModel, n: int = 2) -> torch.Tensor:
    """(..., M, M) SMC' transition matrix between discretized TMRCA intervals.

    The time grid is augmented with each interval's expected coalescence
    time e_i; the 3-state chain is propagated across the 2M - 1
    sub-intervals, and absorbed mass is accumulated per sub-interval as
    a0*p02 + a1*p12, never as a difference of near-1 products.
    """
    eta = dm.eta
    M = eta.M
    c, t = eta.c, eta.t
    c_adj = c * (n - 1)
    dt = torch.diff(t)

    gfrac = texp_mean(c[..., :-1] * dt)
    d_te = torch.cat([torch.clamp_min(dt * gfrac, 0.0), 1.0 / c[..., -1:]], -1)
    d_et = torch.clamp_min(dt * (1.0 - gfrac), 0.0)
    dgrid = torch.cat(
        [torch.stack([d_te[..., :-1], d_et], -1).flatten(-2), d_te[..., -1:]], -1
    )  # (..., 2M - 1): t_0 -> e_0 -> t_1 -> ... -> e_{M-1} -> inf
    degenerate = torch.isclose(dgrid, torch.zeros_like(dgrid))
    dgrid_ok = torch.where(degenerate, torch.ones_like(dgrid), dgrid)
    c_rep = torch.repeat_interleave(c, 2, dim=-1)[..., :-1]
    rho = torch.as_tensor(dm.rho, dtype=c.dtype, device=c.device)[..., None]
    (p00, p01, p10, p11), p02, p12 = _expQ2(2.0 * dgrid_ok * rho, dgrid_ok * c_rep, n)
    one, zero = torch.ones_like(p00), torch.zeros_like(p00)
    p00 = torch.where(degenerate, one, p00)
    p01 = torch.where(degenerate, zero, p01)
    p10 = torch.where(degenerate, zero, p10)
    p11 = torch.where(degenerate, one, p11)
    p02 = torch.where(degenerate, zero, p02)
    p12 = torch.where(degenerate, zero, p12)

    # live occupancy (row 0 of the running 2x2 product) entering each
    # sub-interval, and after the last
    r0, r1 = torch.ones_like(p00[..., 0]), torch.zeros_like(p00[..., 0])
    a0s, a1s = [r0], [r1]
    for k in range(p00.shape[-1]):
        r0, r1 = r0 * p00[..., k] + r1 * p10[..., k], r0 * p01[..., k] + r1 * p11[..., k]
        a0s.append(r0)
        a1s.append(r1)
    a0, a1 = torch.stack(a0s, -1), torch.stack(a1s, -1)  # (..., 2M)

    # absorbed mass within sub-interval k; a trailing pseudo-interval with
    # p02 = p12 = 1 plays the absorbing tail
    inc = torch.cat(
        [a0[..., :-1] * p02 + a1[..., :-1] * p12, (a0[..., -1] + a1[..., -1])[..., None]], -1
    )
    at_e0, at_e1 = a0[..., 1::2], a1[..., 1::2]  # live occupancy at each e_i

    idx = torch.arange(M, device=c.device)
    i, j = idx[:, None], idx[None, :]

    # lower triangle: absorption within full interval j = its two halves
    lower_j = inc[..., 0::2] + inc[..., 1::2]
    lower = lower_j[..., None, :] * (i > j)

    # diagonal: no recombination by e_i, or floating at e_i but re-coalescing
    # before t_{i+1}, or already re-coalesced within [t_i, e_i]
    p_back = _append(-torch.expm1(-d_et * c_adj[..., :-1]), 1.0)
    diag = at_e0 + at_e1 * p_back + inc[..., 0::2]

    # upper triangle: floating at e_i, survives to t_{i+1}, then survives each
    # intermediate interval l and finally coalesces in interval j
    esc = _append(torch.exp(-d_et * c_adj[..., :-1]), 0.0)
    p_float_out = (at_e1 * esc).clamp(1e-8, 1.0 - 1e-8)
    p_surv = _append(torch.exp(-dt * c_adj[..., :-1]), 0.0).clamp(1e-8, 1.0 - 1e-8)
    p_coal = _append(-torch.expm1(-dt * c_adj[..., :-1]), 1.0).clamp(1e-8, 1.0 - 1e-8)
    # prod_{i < l < j} p_surv[l] via cumulative log sums (exclusive prefix)
    cls = torch.cat([torch.zeros_like(p_surv[..., :1]), torch.cumsum(torch.log(p_surv), -1)], -1)
    hi = torch.maximum(j, i + 1).expand(M, M)
    lo = (i + 1).expand(M, M)
    log_span = cls[..., hi] - cls[..., lo]  # sum over l in (i, j)
    upper = p_float_out[..., :, None] * torch.exp(log_span) * p_coal[..., None, :] * (j > i)

    return lower + torch.diag_embed(diag) + upper
