"""The pair HMM's plain reference: the warm-up filter, the log-likelihood and its gradient.

An HMM instance is one particle's (A (M, M), e0, e1, pi) on one chunk's
observations, codes -1 (missing: emission 1), 0 (hom: e0), 1 (het: e1).
Every site applies the transition and then the emission: the forward
state after site t is alpha_t = (alpha_{t-1} A) * f_t, and a chunk's
log-likelihood is log(pi^T G_1 ... G_L 1) with G_t = A diag(f_t).

- `warmup_filter`: the normalized state after a chunk's overlap prefix,
  from pi, site by site, on autograd (the prefix is short).
- `loglik_and_grad`: a body row's log-likelihood and its gradient with
  respect to A, e0, e1 and the row's initial state, without autograd, by
  the forward-backward recursion.  The L sites are cut into blocks of
  about sqrt(L); each block's transfer matrix, the states at the blocks'
  ends in both directions and then every site's posterior counts inside
  all blocks at once are each a loop of about sqrt(L) steps over tensors
  batched across instances and blocks.  The gradient at site t is
  alpha_{t-1}(i) f_t(j) beta_t(j) / Z_t for A and (alpha_{t-1} A)(j)
  beta_t(j) / Z_t for f_t, with Z_t = alpha_{t-1} . G_t beta_t, so any
  scaling of the two vectors cancels.

`Arith` says how products are computed: in the tensors' dtype, or with
both operands rounded to a narrower format first (TF32 or bfloat16, the
lower precisions a control is computed in).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

PAD = 3  # code of a site past the row's end: no transition, no emission
NORM_EVERY = 4  # block-product steps between rescalings


# mantissa bits a product's operands keep: TF32's 10, bfloat16's 7
MANTISSA = {"tf32": 10, "bf16": 7}


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    "float32 values rounded to `bits` mantissa bits (to nearest, ties away from zero)."
    if x.dtype != torch.float32:
        raise ValueError(f"mantissa rounding takes float32, got {x.dtype}")
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    "float32 values rounded to TF32's 10-bit mantissa."
    return round_mantissa(x, MANTISSA["tf32"])


@dataclass(frozen=True)
class Arith:
    """dtype: the tensors'; operands: None, or "tf32" / "bf16": every
    product's operands rounded to that format, accumulated in dtype."""

    dtype: torch.dtype = torch.float64
    operands: str | None = None

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.operands is not None:
            bits = MANTISSA[self.operands]
            a, b = round_mantissa(a, bits), round_mantissa(b, bits)
        return torch.matmul(a, b)


def emission_table(e0: torch.Tensor, e1: torch.Tensor) -> torch.Tensor:
    "(P, 4, M): the emission factor by code + 1 (missing, hom, het, PAD)."
    one = torch.ones_like(e0)
    return torch.stack([one, e0, e1, one], 1)


def warmup_filter(A, e0, e1, pi, warm: torch.Tensor, ar: Arith) -> torch.Tensor:
    """(P, S, M) normalized states after the prefixes warm (S, ov) int8, from
    pi (P, M); differentiable."""
    P, M = pi.shape
    S, ov = warm.shape
    a = pi[:, None, :].expand(P, S, M)
    if ov == 0:
        return a
    F = emission_table(e0, e1)
    code = (warm.long() + 1)
    for t in range(ov):
        a = ar.mm(a, A) * F[:, code[:, t]]
        if (t + 1) % 8 == 0 or t == ov - 1:
            a = a / a.sum(-1, keepdim=True)
    return a


def _codes(rows: torch.Tensor, Lb: int):
    "Codes + 1 of rows (S, L), padded with PAD to whole blocks of Lb: (S, nb, Lb)."
    S, L = rows.shape
    nb = -(-L // Lb)
    code = torch.full((S, nb * Lb), PAD, dtype=torch.long, device=rows.device)
    code[:, :L] = rows.long() + 1
    return code.view(S, nb, Lb)


def _blocks(A, F, code, ar: Arith):
    "Each block's transfer matrix, rescaled: (X (P, S, nb, M, M), log scales (P, S, nb))."
    P, M = A.shape[0], A.shape[-1]
    S, nb, Lb = code.shape
    pad = code == PAD
    Ab = A[:, None, None]
    X = torch.eye(M, dtype=A.dtype, device=A.device).expand(P, S, nb, M, M).clone()
    logs = torch.zeros(P, S, nb, dtype=A.dtype, device=A.device)
    for j in range(Lb):
        Xn = ar.mm(X, Ab) * F[:, code[:, :, j]][..., None, :]
        X = torch.where(pad[None, :, :, j, None, None], X, Xn)
        if (j + 1) % NORM_EVERY == 0 or j == Lb - 1:
            s = X.amax((-1, -2))
            X = X / s[..., None, None]
            logs = logs + torch.log(s)
    return X, logs


def _forward_blocks(pi, X, logs, ar: Arith):
    "(ll (P, S), the normalized states entering each block (P, S, nb, M))."
    P, S, nb, M = X.shape[:4]
    a = pi
    ll = torch.zeros(P, S, dtype=X.dtype, device=X.device)
    alphas = torch.empty(P, S, nb, M, dtype=X.dtype, device=X.device)
    for b in range(nb):
        alphas[:, :, b] = a
        v = ar.mm(a[..., None, :], X[:, :, b])[..., 0, :]
        c = v.sum(-1)
        ll = ll + torch.log(c) + logs[:, :, b]
        a = v / c[..., None]
    return ll, alphas


def _block(L: int, block: int | None) -> int:
    return block or max(1, math.isqrt(L - 1) + 1)


@torch.no_grad()
def loglik(A, e0, e1, pi, rows: torch.Tensor, ar: Arith, block: int = None) -> torch.Tensor:
    "(P, S) log-likelihoods of the body rows (S, L) from initial states pi (P, S, M)."
    code = _codes(rows, _block(rows.shape[1], block))
    X, logs = _blocks(A, emission_table(e0, e1), code, ar)
    return _forward_blocks(pi, X, logs, ar)[0]


@torch.no_grad()
def loglik_and_grad(A, e0, e1, pi, rows: torch.Tensor, ar: Arith, block: int = None):
    """Body rows (S, L) int8 from initial states pi (P, S, M): (ll (P, S),
    dA (P, M, M) and de0, de1 (P, M) summed over the rows, dpi (P, S, M))."""
    P, S, M = pi.shape
    code = _codes(rows, _block(rows.shape[1], block))
    nb, Lb = code.shape[1:]
    pad = code == PAD  # (S, nb, Lb)
    F = emission_table(e0, e1)
    Ab = A[:, None, None]  # (P, 1, 1, M, M)
    X, logs = _blocks(A, F, code, ar)
    ll, alphas = _forward_blocks(pi, X, logs, ar)

    # the backward states leaving each block, and the initial state's gradient
    bvec = torch.ones(P, S, M, dtype=A.dtype, device=A.device)
    betas = torch.empty(P, S, nb, M, dtype=A.dtype, device=A.device)
    for b in reversed(range(nb)):
        betas[:, :, b] = bvec
        w = ar.mm(X[:, :, b], bvec[..., None])[..., 0]
        bvec = w / w.sum(-1, keepdim=True)
    dpi = bvec / (pi * bvec).sum(-1, keepdim=True)
    del X

    # every site's posterior counts, all blocks at once
    store = torch.empty(Lb, P, S, nb, M, dtype=A.dtype, device=A.device)
    a = alphas
    for j in range(Lb):
        store[j] = a
        an = ar.mm(a[..., None, :], Ab)[..., 0, :] * F[:, code[:, :, j]]
        an = an / an.sum(-1, keepdim=True)
        a = torch.where(pad[None, :, :, j, None], a, an)
    dA = torch.zeros(P, M, M, dtype=A.dtype, device=A.device)
    de = torch.zeros(P, 4, M, dtype=A.dtype, device=A.device)
    bvec = betas
    for j in reversed(range(Lb)):
        ap = store[j]
        fb = F[:, code[:, :, j]] * bvec
        Gb = ar.mm(Ab, fb[..., None])[..., 0]
        wgt = (~pad[None, :, :, j]) / (ap * Gb).sum(-1)  # 1 / Z_t, 0 on PAD sites
        dA = dA + ar.mm((ap * wgt[..., None]).reshape(P, -1, M).transpose(1, 2),
                        fb.reshape(P, -1, M))
        df = ar.mm(ap[..., None, :], Ab)[..., 0, :] * bvec * wgt[..., None]
        onehot = torch.nn.functional.one_hot(code[:, :, j], 4).to(A.dtype)  # (S, nb, 4)
        de = de + torch.einsum("psbm,sbk->pkm", df, onehot)
        bn = Gb / Gb.sum(-1, keepdim=True)
        bvec = torch.where(pad[None, :, :, j, None], bvec, bn)
    return ll, dA, de[:, 1], de[:, 2], dpi


def loglik_plain(A, e0, e1, pi, rows: torch.Tensor) -> torch.Tensor:
    """(P, S) log-likelihoods site by site, rescaled every site: the
    recursion loglik_and_grad blocks (for tests at small sizes)."""
    F = emission_table(e0, e1)
    code = rows.long() + 1
    a, ll = pi, torch.zeros(pi.shape[:2], dtype=pi.dtype, device=pi.device)
    for t in range(rows.shape[1]):
        a = torch.matmul(a, A) * F[:, code[:, t]]
        c = a.sum(-1)
        ll = ll + torch.log(c)
        a = a / c[..., None]
    return ll
