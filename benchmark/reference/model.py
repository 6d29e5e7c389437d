"""The model's plain reference: particle coordinates to the HMM, the prior and the AFS term.

A frozen copy of the plain PyTorch arithmetic of phlash_tpu_torch's params,
size_history, transition, afs and ops/assembly (log_prior, log_afs), which
the repository's CPU tests hold to phlash_tpu (JAX), written as functions
of tensors.  It imports nothing of the program.  The HMM it hands on is the
whole M x M transition matrix with its emissions and initial
distribution: the program compresses the same matrix to its diagonals and
a rank-one upper triangle for its kernels; the reference does not.

Flat coordinates (P, D), D = 2 + K + 1: [log t1, log(tM - t1)], the
inverse-softplus coalescence rates of the K tied groups, and the logit of
(rho / theta - 0.1) / 9.9.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch


# -- numerics (phlash_tpu_torch/utils/numerics.py) ----------------------------

def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def softplus_inv(y):
    return y + torch.log1p(-torch.exp(-y))


def expm1inv(x):
    big = x > 10.0
    x_lo = torch.where(big, torch.ones_like(x), x)
    return torch.where(big, -torch.exp(-x) / torch.expm1(-x), 1.0 / torch.expm1(x_lo))


def texp_mean(x):
    "Mean of a rate-x exponential truncated to [0, 1]; the cubic Taylor form for |x| < 0.1."
    small = torch.abs(x) < 0.1
    x_safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 0.5 - x / 12.0 + x**3 / 720.0, 1.0 / x_safe - expm1inv(x_safe))


def _append(x, value: float):
    return torch.cat([x, torch.full_like(x[..., :1], value)], -1)


# -- the pattern and the coordinates (utils/pattern.py, params.py) -----------

def pattern_widths(pattern: str) -> list[int]:
    "'14*1+1*2' -> [1] * 14 + [2]: the widths of the tied groups."
    widths = []
    for term in pattern.split("+"):
        reps, w = term.split("*") if "*" in term else (1, term)
        widths += [int(w)] * int(reps)
    return widths


def expand_index(pattern: str) -> np.ndarray:
    "Interval -> its group."
    w = pattern_widths(pattern)
    return np.repeat(np.arange(len(w)), w)


def init_coordinates(pattern: str, t1: float, tM: float, theta: float, rho: float) -> torch.Tensor:
    "(D,) float64 coordinates of a constant history (c = 1) on [t1, tM]."
    K = len(pattern_widths(pattern))
    f = lambda v: torch.as_tensor(v, dtype=torch.float64)  # noqa: E731
    return torch.cat([torch.stack([torch.log(f(t1)), torch.log(f(tM) - f(t1))]),
                      softplus_inv(torch.ones(K, dtype=torch.float64)),
                      torch.logit(f((rho / theta - 0.1) / 9.9))[None]])


def history(x: torch.Tensor, pattern: str, theta: float):
    """(t (P, M), c (P, M), rho (P,), rho_over_theta (P,), c groups (P, K)):
    the geometric time grid on [t1, tM] and the expanded rates."""
    K = len(pattern_widths(pattern))
    idx = torch.as_tensor(expand_index(pattern), device=x.device)
    M = len(idx)
    e = torch.exp(x[:, :2])
    t1, tM = e[:, 0], e[:, 0] + e[:, 1]
    lo, hi = torch.log(t1)[:, None], torch.log(tM)[:, None]
    k = torch.arange(M - 1, dtype=x.dtype, device=x.device) / (M - 2)
    t = torch.cat([torch.zeros_like(lo), torch.exp(lo + (hi - lo) * k)], -1)
    cg = softplus(x[:, 2:2 + K])
    rot = 0.1 + 9.9 * torch.sigmoid(x[:, 2 + K])
    return t, cg[:, idx], rot * theta, rot, cg


def coordinates(t: torch.Tensor, c: torch.Tensor, rho: torch.Tensor, theta: float,
                pattern: str) -> torch.Tensor:
    "history's inverse: (P, D) coordinates of a grid t, expanded rates c and rho."
    first = np.cumsum([0] + pattern_widths(pattern))[:-1]
    t1, tM = t[:, 1], t[:, -1]
    return torch.cat([torch.stack([torch.log(t1), torch.log(tM - t1)], -1),
                      softplus_inv(c[:, first]),
                      torch.logit((rho / theta - 0.1) / 9.9)[:, None]], -1)


# -- the size history (size_history.py) ---------------------------------------

def p_coal(t, c):
    "P(coalescence in each epoch): the HMM's initial distribution."
    surv = _append(torch.exp(-torch.cumsum(c[:, :-1] * torch.diff(t), -1)), 0.0)
    interior = -torch.diff(surv)
    return torch.cat([1.0 - interior.sum(-1, keepdim=True), interior], -1)


def ect(t, c):
    "Expected coalescence time given coalescence in each epoch."
    t0, dt = t[:, :-1], torch.diff(t)
    inner = t0 + dt * texp_mean(c[:, :-1] * dt)
    return torch.clamp_min(torch.cat([inner, t[:, -1:] + 1.0 / c[:, -1:]], -1), 1e-20)


def w_matrix(n: int) -> np.ndarray:
    "Polanski-Kimmel W (eqs. 13-15), exact rationals cast once."
    rows = []
    for b in range(1, n):
        w = [Fraction(6, n + 1)]
        if n >= 3:
            w.append(Fraction(30 * (n - 2 * b), (n + 1) * (n + 2)))
        for j in range(2, n - 1):
            lead = Fraction(3 + 2 * j, j * (n + j + 1))
            w.append(lead * ((n - 2 * b) * w[-1] - Fraction((1 + j) * (n - j), 2 * j - 1) * w[-2]))
        rows.append([float(v) for v in w])
    return np.array(rows, dtype=np.float64)


def etbl(t, c, n: int):
    "Expected branch length subtending 1..n-1 leaves, (P, n-1)."
    dt = torch.diff(t)
    haz = torch.cat([torch.zeros_like(c[:, :1]), torch.cumsum(c[:, :-1] * dt, -1)], -1)
    j = np.arange(2, n + 1)
    m = torch.as_tensor(j * (j - 1) // 2, dtype=c.dtype, device=c.device)
    mh = m[:, None] * haz[:, None, :]
    finite = (torch.exp(-mh[..., :-1]) * -torch.expm1(-m[:, None] * (c[:, :-1] * dt)[:, None, :])
              / (m[:, None] * c[:, None, :-1]))
    last = torch.exp(-mh[..., -1]) / (m * c[:, -1:])
    etjj = finite.sum(-1) + last
    return etjj @ torch.as_tensor(w_matrix(n), dtype=c.dtype, device=c.device).T


# -- the SMC' transition (transition.py) ---------------------------------------

def _expq2(r, c, n: int):
    u = torch.sqrt((c * n) ** 2 - 2.0 * c * (n - 2) * r + r**2) / 2.0
    v = (r + c * n) / 2.0
    w = (r - c * n) / 2.0
    ab = c * r * (n - 1)
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
    s_plus = torch.where(w <= 0, small, big)
    s_minus = torch.where(w <= 0, big, small)
    p00 = torch.where(tiny, torch.exp(-v) * (1.0 - w),
                      (exp_a * s_minus + exp_b * s_plus) / (2.0 * u_ok))
    p11 = torch.where(tiny, torch.exp(-v) * (1.0 + w),
                      (exp_a * s_plus + exp_b * s_minus) / (2.0 * u_ok))
    generic0 = (b * ea - a * eb) / (2.0 * u_ok)
    series, h, bp, fact = 0.0, one, one, 2.0
    for k in range(2, 8):
        series = series + h / fact
        bp = bp * b
        h = a * h + bp
        fact = fact * (k + 1)
    p02 = torch.where(torch.maximum(torch.abs(a), torch.abs(b)) < 0.05, ab * series, generic0)
    kappa = c + w
    generic1 = -((u_ok + kappa) * ea + (u_ok - kappa) * eb) / (2.0 * u_ok)
    limit1 = -(torch.expm1(-v) + kappa * torch.exp(-v))
    p12 = torch.where(tiny, limit1, generic1)
    return (p00, r * shu, c * shu, p11), p02, p12


def transition_matrix(t, c, rho, n: int = 2):
    "(P, M, M) SMC' transition between the TMRCA intervals of the grid t."
    M = t.shape[-1]
    c_adj = c * (n - 1)
    dt = torch.diff(t)
    gfrac = texp_mean(c[:, :-1] * dt)
    d_te = torch.cat([torch.clamp_min(dt * gfrac, 0.0), 1.0 / c[:, -1:]], -1)
    d_et = torch.clamp_min(dt * (1.0 - gfrac), 0.0)
    dgrid = torch.cat([torch.stack([d_te[:, :-1], d_et], -1).flatten(-2), d_te[:, -1:]], -1)
    degenerate = torch.isclose(dgrid, torch.zeros_like(dgrid))
    dgrid_ok = torch.where(degenerate, torch.ones_like(dgrid), dgrid)
    c_rep = torch.repeat_interleave(c, 2, dim=-1)[:, :-1]
    (p00, p01, p10, p11), p02, p12 = _expq2(2.0 * dgrid_ok * rho[:, None], dgrid_ok * c_rep, n)
    one, zero = torch.ones_like(p00), torch.zeros_like(p00)
    p00 = torch.where(degenerate, one, p00)
    p01 = torch.where(degenerate, zero, p01)
    p10 = torch.where(degenerate, zero, p10)
    p11 = torch.where(degenerate, one, p11)
    p02 = torch.where(degenerate, zero, p02)
    p12 = torch.where(degenerate, zero, p12)
    r0, r1 = torch.ones_like(p00[:, 0]), torch.zeros_like(p00[:, 0])
    a0s, a1s = [r0], [r1]
    for k in range(p00.shape[-1]):
        r0, r1 = r0 * p00[:, k] + r1 * p10[:, k], r0 * p01[:, k] + r1 * p11[:, k]
        a0s.append(r0)
        a1s.append(r1)
    a0, a1 = torch.stack(a0s, -1), torch.stack(a1s, -1)
    inc = torch.cat([a0[:, :-1] * p02 + a1[:, :-1] * p12, (a0[:, -1] + a1[:, -1])[:, None]], -1)
    at_e0, at_e1 = a0[:, 1::2], a1[:, 1::2]
    idx = torch.arange(M, device=c.device)
    i, j = idx[:, None], idx[None, :]
    lower = (inc[:, 0::2] + inc[:, 1::2])[:, None, :] * (i > j)
    p_back = _append(-torch.expm1(-d_et * c_adj[:, :-1]), 1.0)
    diag = at_e0 + at_e1 * p_back + inc[:, 0::2]
    esc = _append(torch.exp(-d_et * c_adj[:, :-1]), 0.0)
    p_float_out = (at_e1 * esc).clamp(1e-8, 1.0 - 1e-8)
    p_surv = _append(torch.exp(-dt * c_adj[:, :-1]), 0.0).clamp(1e-8, 1.0 - 1e-8)
    p_co = _append(-torch.expm1(-dt * c_adj[:, :-1]), 1.0).clamp(1e-8, 1.0 - 1e-8)
    cls = torch.cat([torch.zeros_like(p_surv[:, :1]), torch.cumsum(torch.log(p_surv), -1)], -1)
    hi = torch.maximum(j, i + 1).expand(M, M)
    lo = (i + 1).expand(M, M)
    upper = (p_float_out[:, :, None] * torch.exp(cls[:, hi] - cls[:, lo])
             * p_co[:, None, :] * (j > i))
    return lower + torch.diag_embed(diag) + upper


# -- the HMM, the prior and the AFS term -----------------------------------------

def clip(a):
    return a.clamp(1e-20, 1.0 - 1e-20)


def hmm(x: torch.Tensor, pattern: str, theta: float):
    """(A (P, M, M), e0 (P, M), e1 (P, M), pi (P, M), t, c): the transition,
    P(hom | state), P(het | state) and the initial distribution."""
    t, c, rho, _, _ = history(x, pattern, theta)
    lam = theta * ect(t, c)
    return (clip(transition_matrix(t, c, rho)), clip(torch.exp(-lam)), clip(-torch.expm1(-lam)),
            clip(p_coal(t, c)), t, c)


def log_prior(x: torch.Tensor, pattern: str, theta: float, alpha: float, beta: float):
    "Standard normal on log(rho / theta), alpha on the rates' smoothness, beta a ridge."
    _, _, _, rot, cg = history(x, pattern, theta)
    lr = torch.log(rot)
    lp = -(math.log(2.0 * math.pi) + lr**2) / 2.0
    lp = lp - alpha * (torch.diff(torch.log(cg)) ** 2).sum(-1)
    return lp - beta * (x * x).sum(-1)


def log_afs(t, c, afs: torch.Tensor, T: torch.Tensor):
    "(P,) AFS composite log-likelihood through the transform T."
    n = afs.shape[-1] + 1
    e = etbl(t, c, n)
    esfs = e / e.sum(-1, keepdim=True)
    return torch.special.xlogy(T @ afs, (T * esfs[:, None, :]).sum(-1)).sum(-1)


def fold_transform(n: int) -> np.ndarray:
    rows = (n - 1) // 2 + (n - 1) % 2
    T = np.eye(N=rows, M=n - 1)
    T += T[:, ::-1]
    T /= T.sum(0)
    return T


def bws_transform(afs, alpha: float = 0.1) -> np.ndarray:
    afs = np.asarray(afs)
    n = len(afs) + 1
    cum = np.cumsum(afs) / afs.sum()
    k = np.searchsorted(cum, 1.0 - alpha, side="right") + 1
    T = np.eye(N=k, M=n - 1)
    if k < n - 1:
        T = np.concatenate([T, (np.arange(n - 1)[None] >= k).astype(float)])
    return T


def default_afs_transform(afs) -> np.ndarray:
    "Fold, then bin the folded spectrum's rare tail."
    T1 = fold_transform(len(afs) + 1)
    return bws_transform(T1 @ np.asarray(afs)) @ T1
