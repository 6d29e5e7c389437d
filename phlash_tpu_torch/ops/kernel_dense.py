"""Batched dense-transition HMM kernel in plain PyTorch.

Port of phlash_tpu/ops/kernel_dense.py:30-134.  The forward recursion is a
dense `alpha @ A` product per site, batched over (particle, chunk), with
rescaling at every site (normalizer clamped at 1e-35); the site loop runs
in segments of ~sqrt(L) sites, each wrapped in `torch.utils.checkpoint`
when autograd records, so the backward pass keeps O(L / seg_len) states
per sequence instead of O(L).  Padding (-2) freezes the state and adds
nothing to ll; missing (-1) advances it with emission factor 1.

This is `kernel_backend="dense"` on either device, and the gradient oracle
of the packed kernel pair (ops/kernel_packed.py).  It launches no kernel of
this package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from phlash_tpu_torch.ops.packing import dense_transition
from phlash_tpu_torch.params import PSMCParams

TINY = 1e-35  # per-site normalizer clamp (kernel_dense.py:64)


def _pick_seg_len(L: int) -> int:
    "Segment length ~ sqrt(L), rounded up to a multiple of 128, in [128, 4096]."
    target = int(np.sqrt(L))
    return int(np.clip(((target + 127) // 128) * 128, 128, 4096))


def _segment(A, emis, alpha, ll, obs):
    """Advance alpha (B, S, M) over the sites of obs (S, T); ll (B, S) gains
    the segment's log-normalizers.  emis (B, 3, M): emis0, emis1, ones."""
    idx = obs.clamp(-1, 1).long() % 3  # 0 -> emis0, 1 -> emis1, -1 and -2 -> ones
    ll_seg = torch.zeros_like(ll)
    for t in range(obs.shape[1]):
        a2 = torch.matmul(alpha, A) * emis[:, idx[:, t]]
        norm = torch.clamp_min(a2.sum(-1), TINY)
        live = (obs[:, t] >= -1)[None, :]
        alpha = torch.where(live[..., None], a2 / norm[..., None], alpha)
        ll_seg = ll_seg + torch.where(live, torch.log(norm), 0.0)
    return alpha, ll + ll_seg


def forward_ll_dense(pp: PSMCParams, obs: torch.Tensor, seg_len: int = 512):
    """(final filtered state (B, S, M), log-likelihood (B, S)).

    pp leaves (B, M) except pi, (B, S, M); obs (S, L) int8 rows.  The last
    segment is shorter instead of padded: padded sites are no-ops.
    """
    A = dense_transition(pp)
    emis = torch.stack([pp.emis0, pp.emis1, torch.ones_like(pp.emis0)], 1)
    alpha = pp.pi
    ll = torch.zeros(alpha.shape[:2], dtype=alpha.dtype, device=alpha.device)
    for lo in range(0, obs.shape[1], seg_len):
        seg = obs[:, lo: lo + seg_len]
        if torch.is_grad_enabled():
            # the segment draws no random numbers, so there is no generator
            # state to keep (reading it is not allowed in a CUDA graph capture)
            alpha, ll = checkpoint(_segment, A, emis, alpha, ll, seg, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            alpha, ll = _segment(A, emis, alpha, ll, seg)
    return alpha, ll


class DenseKernel(nn.Module):
    """Dense-transition likelihood kernel over a device-resident chunk tensor.

    data: int8 (N, L) chunks in {-1, 0, 1}.  Runs in the parameters' dtype,
    or in float64 with double_precision=True, on whatever device `data`
    lives on.
    """

    def __init__(self, M: int, data, device="cpu", seg_len: int = None,
                 double_precision: bool = False):
        super().__init__()
        self.M = M
        self.double_precision = double_precision
        self.register_buffer("data", torch.as_tensor(data, dtype=torch.int8, device=device))
        self.seg_len = seg_len or _pick_seg_len(self.data.shape[-1])

    def loglik_batched(self, pp: PSMCParams, inds: torch.Tensor) -> torch.Tensor:
        """(B, S) log-likelihoods of chunks `inds` (S,); pp leaves (B, M)
        except pi, (B, S, M): the per-chunk initial distributions."""
        return self.loglik_rows(pp, self.data[inds])

    def loglik_rows(self, pp: PSMCParams, rows: torch.Tensor) -> torch.Tensor:
        "loglik_batched on the body rows (S, L) themselves (a mesh fetches them, see parallel/)."
        if self.double_precision:
            pp = pp.to(torch.float64)
        return forward_ll_dense(pp, rows, self.seg_len)[1]

    def filter_batched(self, pp: PSMCParams, warmup: torch.Tensor) -> torch.Tensor:
        """Filtered state after the warmup prefixes, (B, S, M), differentiable.
        pp leaves (B, M); warmup (S, overlap) int8, shared across particles."""
        if self.double_precision:
            pp = pp.to(torch.float64)
        S = warmup.shape[0]
        pi = pp.pi[:, None, :].expand(-1, S, -1)
        return forward_ll_dense(pp.replace(pi=pi), warmup.to(torch.int8), self.seg_len)[0]
