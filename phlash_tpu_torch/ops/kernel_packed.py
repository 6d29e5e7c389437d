"""Dense-transition ("packed") likelihood kernel: autograd wrapper and module.

Port of phlash_tpu/ops/kernel_pallas.py:68-192.  `PackedOp` is the
torch.autograd.Function that replaces the JAX custom VJP `_packed_ll`: its
forward runs the forward kernel (B4; segment checkpoints only when a
gradient is wanted), its backward the adjoint (B5), returning dA, de0, de1
and dpi; autograd carries dA back through `packing.dense_transition` to
b, d, u, v.  Its backward sums each particle's gradients over the chunks;
`packed_instance_grads` runs the same pair outside autograd and keeps them
per chunk.  `PackedKernel` owns the device-resident int8 chunk tensor,
padded with -2 to a multiple of `seg_len`, and exposes `loglik_batched` and
the per-particle entries of kernel_base.py.  Like phlash_tpu's PallasKernel
it has no `filter_batched`, so it serves fits without a warm-up prefix
(overlap 0) only.

The TPU's padding of particles to groups of 8 and of chunks to 8 rows (with
identity HMMs) is not needed: the CUDA kernels take any B and S.
"""

from __future__ import annotations

import numpy as np
import torch

from phlash_tpu_torch.kernel_base import (LikelihoodKernel, batched_vjp, kernel_dtype, one_particle,
                                          upload)
from phlash_tpu_torch.ops import packed
from phlash_tpu_torch.ops.packing import dense_transition
from phlash_tpu_torch.params import PSMCParams


def _forward(A, e0, e1, pi, obs, seg_len: int, with_ckpt: bool):
    "B4: (ll (B, S), segment checkpoints when with_ckpt)."
    return packed.forward(A.contiguous(), e0.contiguous(), e1.contiguous(), pi.contiguous(),
                          obs, seg_len, with_ckpt)


def _adjoint(A, e0, e1, obs, ckpt, g_ll, seg_len: int):
    """B5: the per-instance gradients dA (B, S, M, M), de0 / de1 (B, S, M) and
    dpi (B, S, M), which PackedOp's backward sums over the chunks and
    packed_instance_grads keeps."""
    return packed.backward(A.contiguous(), e0.contiguous(), e1.contiguous(), obs, ckpt,
                           g_ll.contiguous(), seg_len)


class PackedOp(torch.autograd.Function):
    "ll (B, S) from A (B, M, M), emis0 / emis1 (B, M), pi (B, S, M) and obs (S, L) rows."

    @staticmethod
    def forward(ctx, obs, seg_len, with_ckpt, A, e0, e1, pi):
        ll, ckpt = _forward(A, e0, e1, pi, obs, seg_len, with_ckpt)
        if with_ckpt:
            ctx.seg_len = seg_len
            ctx.save_for_backward(obs, ckpt, A, e0, e1)
        return ll

    @staticmethod
    def backward(ctx, g_ll):
        # only reached when forward kept checkpoints
        obs, ckpt, A, e0, e1 = ctx.saved_tensors
        dA, de0, de1, dpi = _adjoint(A, e0, e1, obs, ckpt, g_ll, ctx.seg_len)
        return None, None, None, dA.sum(1), de0.sum(1), de1.sum(1), dpi


def packed_op(A, emis0, emis1, pi, obs, seg_len: int = packed.DEFAULT_SEG) -> torch.Tensor:
    """Run the kernel pair; checkpoints are kept only when autograd will ask.
    The inputs are cast to the kernels' dtype (autograd casts their
    gradients back) and ll to pi's dtype."""
    leaves = kernel_dtype((A, emis0, emis1, pi), obs.device)
    with_ckpt = torch.is_grad_enabled() and any(x.requires_grad for x in leaves)
    return PackedOp.apply(obs, seg_len, with_ckpt, *leaves).to(pi.dtype)


def _dense_of(pp: PSMCParams):
    return lambda b, d, u, v: dense_transition(pp.replace(b=b, d=d, u=u, v=v))


def packed_instance_grads(pp: PSMCParams, obs: torch.Tensor, seg_len: int):
    """(ll (n,), each chunk's gradient of pp's leaves, (n, M) each) for one
    particle pp, unbatched leaves, on the rows obs (n, L'): one forward with
    checkpoints (B4) and one adjoint (B5) at (B, S) = (1, n), outside
    autograd, cast as packed_op casts; the per-instance dA (n, M, M) goes
    back through dense_transition in one batched VJP."""
    one = one_particle(pp, obs.shape[0])
    A, e0, e1, pi = kernel_dtype((dense_transition(pp)[None], one.emis0, one.emis1, one.pi),
                                 obs.device)
    ll, ckpt = _forward(A, e0, e1, pi, obs, seg_len, True)
    dA, de0, de1, dpi = _adjoint(A, e0, e1, obs, ckpt, torch.ones_like(ll), seg_len)
    dtype = pp.pi.dtype
    db, dd, du, dv = batched_vjp(_dense_of(pp), (pp.b, pp.d, pp.u, pp.v), dA[0].to(dtype))
    return ll[0].to(dtype), PSMCParams(db, dd, du, dv, *(x[0].to(dtype) for x in (de0, de1, dpi)))


class PackedKernel(LikelihoodKernel):
    """Dense-transition likelihood kernel over a device-resident chunk tensor.

    data: int8 (N, L) chunks in {-1, 0, 1}, placed on `device` (cuda unless
    asked for the CPU).  M must be 16.  On a CUDA device the hand kernels
    run, in float32 (packed_op casts at the boundary); on the CPU their
    plain versions, in the parameters' dtype (see ops/packed.py).
    """

    def __init__(self, M: int, data, device="cuda", seg_len: int = packed.DEFAULT_SEG):
        super().__init__()
        if M != packed.M:
            raise ValueError(f"the packed kernel requires M={packed.M}, got {M}")
        data = np.asarray(data)
        self.M, self.L, self.seg_len = M, data.shape[-1], seg_len
        L_pad = -(-self.L // seg_len) * seg_len
        padded = np.pad(data, [(0, 0), (0, L_pad - self.L)], constant_values=-2)
        self.register_buffer("data", upload(padded, device))

    def instance_grads(self, pp: PSMCParams, rows: torch.Tensor):
        return packed_instance_grads(pp, rows.contiguous(), self.seg_len)

    def loglik_rows(self, pp: PSMCParams, rows: torch.Tensor) -> torch.Tensor:
        "loglik_batched on rows (S, L') of `data`, padding included (a mesh fetches them)."
        return packed_op(dense_transition(pp), pp.emis0, pp.emis1, pp.pi, rows.contiguous(),
                         self.seg_len)
