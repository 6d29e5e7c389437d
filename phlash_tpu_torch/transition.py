"""SMC' discretized transition matrix over TMRCA intervals.

Port of phlash_tpu/transition.py: `_expQ2` (the 2x2 live block of the
3-state SMC' chain's e^Q with stable absorption probabilities) and
`transition_matrix`; and the test oracles `expQ` (the whole 3x3 e^Q, held
to scipy.linalg.expm) and `q_s` (the continuous transition density, held to
quadrature).  Leading axes are batch axes.  The JAX package composes the
2x2 blocks with an associative scan; only row 0 of the running product is
ever read, so the port propagates that row sequentially over the 2M - 1
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


def expQ(r, c, n: int) -> torch.Tensor:
    """e^Q (..., 3, 3) of the SMC' rate generator over one interval, in closed
    form, elementwise over r and c (numbers or tensors; float64 for numbers).

    Q generates a 3-state chain: 0 = lineages coalesced (no recombination
    separating the two loci yet), 1 = a floating lineage, 2 = re-coalesced
    elsewhere (absorbing); r is the scaled recombination distance, c the
    scaled coalescence intensity over the interval, n the sample size.  The
    live 2x2 block's eigen-decomposition goes through cosh / sinh; sinh(u)/u
    is series-expanded for small u, so gradients stay finite.
    """
    r, c = (x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.float64)
            for x in (r, c))
    r, c = torch.broadcast_tensors(r, c)
    u = torch.sqrt((c * n) ** 2 - 2.0 * c * (n - 2) * r + r**2) / 2.0
    v = (r + c * n) / 2.0
    w = (r - c * n) / 2.0
    # e^{-v} cosh(u) and e^{-v} sinh(u) / u, overflow-safe through exp(u - v)
    ch = (torch.exp(u - v) + torch.exp(-(u + v))) / 2.0
    tiny = u < 1e-6
    u_ok = torch.where(tiny, torch.ones_like(u), u)
    sh_over_u = torch.where(tiny, torch.exp(-v) * (1.0 + u_ok**2 / 6.0),
                            (torch.exp(u - v) - torch.exp(-(u + v))) / (2.0 * u_ok))
    p00, p01 = ch - w * sh_over_u, r * sh_over_u
    p10, p11 = c * sh_over_u, ch + w * sh_over_u
    zero, one = torch.zeros_like(u), torch.ones_like(u)
    rows = [(p00, p01, 1.0 - p00 - p01), (p10, p11, 1.0 - p10 - p11), (zero, zero, one)]
    return torch.stack([torch.stack(row, -1) for row in rows], -2)


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


def q_s(*, eta, s: float, r: float):
    """The continuous SMC' transition density from TMRCA s to TMRCA t at
    scaled recombination distance r, for one SizeHistory: (q, atom), q
    taking a tensor of t (float64) and atom = P(stay at s).  A test oracle
    (q integrates to 1 - atom).

    The exact density, as phlash_tpu's: for t < s the 3-state chain is cut
    at t, so q(t < s) = eta(t) P_{0->t}[0, 1] (the reference cuts it at s,
    right only as r -> 0).  P_{0->x} is the product of expQ over the
    history's intervals below x, then over [t_j, x]: the full intervals'
    products are taken once, sequentially, at float64.
    """
    t = eta.t.to(torch.float64)
    c = eta.c.to(torch.float64)
    full = expQ(torch.diff(t) * r, torch.diff(t) * c[:-1], 2)  # (K - 1, 3, 3)
    prefix = [torch.eye(3, dtype=torch.float64)]
    for E in full:
        prefix.append(prefix[-1] @ E)
    prefix = torch.stack(prefix)  # (K, 3, 3): the chain at each breakpoint

    def chain_at(x: torch.Tensor) -> torch.Tensor:
        "(..., 3, 3): the chain after evolving over branch heights [0, x]."
        j = torch.searchsorted(t, x.contiguous(), right=True) - 1
        dx = x - t[j]
        return prefix[j] @ expQ(dx * r, dx * c[j], 2)

    R = eta.R
    s_ = torch.tensor([float(s)], dtype=torch.float64)
    P_s, R_s = chain_at(s_)[0], R(s_)

    def q(x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float64)
        flat = x.reshape(-1)
        below = chain_at(flat)[:, 0, 1]
        above = P_s[0, 1] * torch.exp(-(R(flat) - R_s))
        return (eta(flat).to(torch.float64) * torch.where(flat < s, below, above)).reshape(x.shape)

    return q, P_s[0, 0]
