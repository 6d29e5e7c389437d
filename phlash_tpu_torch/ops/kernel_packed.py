"""Dense-transition ("packed") likelihood kernel: autograd wrapper and module.

Port of phlash_tpu/ops/kernel_pallas.py:68-192.  `PackedOp` is the
torch.autograd.Function that replaces the JAX custom VJP `_packed_ll`: its
forward runs the forward kernel (B4; segment checkpoints only when a
gradient is wanted), its backward the adjoint (B5), returning dA, de0, de1
and dpi; autograd carries dA back through `packing.dense_transition` to
b, d, u, v.  `PackedKernel` owns the device-resident int8 chunk tensor,
padded with -2 to a multiple of `seg_len`, and exposes `loglik_batched`.
Like phlash_tpu's PallasKernel it has no `filter_batched`, so it serves
fits without a warm-up prefix (overlap 0) only.

The TPU's padding of particles to groups of 8 and of chunks to 8 rows (with
identity HMMs) is not needed: the CUDA kernels take any B and S.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from phlash_tpu_torch.ops import build, packed
from phlash_tpu_torch.ops.packing import dense_transition
from phlash_tpu_torch.params import PSMCParams


class PackedOp(torch.autograd.Function):
    "ll (B, S) from A (B, M, M), emis0 / emis1 (B, M), pi (B, S, M) and obs (S, L) rows."

    @staticmethod
    def forward(ctx, obs, seg_len, with_ckpt, A, e0, e1, pi):
        A, e0, e1 = A.contiguous(), e0.contiguous(), e1.contiguous()
        ll, ckpt = packed.forward(A, e0, e1, pi.contiguous(), obs, seg_len, with_ckpt)
        if with_ckpt:
            ctx.seg_len = seg_len
            ctx.save_for_backward(obs, ckpt, A, e0, e1)
        return ll

    @staticmethod
    def backward(ctx, g_ll):
        # only reached when forward kept checkpoints
        obs, ckpt, A, e0, e1 = ctx.saved_tensors
        dA, de0, de1, dpi = packed.backward(A, e0, e1, obs, ckpt, g_ll.contiguous(), ctx.seg_len)
        return None, None, None, dA.sum(1), de0.sum(1), de1.sum(1), dpi


def packed_op(A, emis0, emis1, pi, obs, seg_len: int = packed.DEFAULT_SEG) -> torch.Tensor:
    """Run the kernel pair; checkpoints are kept only when autograd will ask.
    The kernels take build.KERNEL_DTYPE (float32 on CUDA): the inputs are
    cast to it here (autograd casts their gradients back) and ll to pi's dtype,
    so a float64 tensor never reaches a kernel."""
    leaves = (A, emis0, emis1, pi)
    dtype = build.KERNEL_DTYPE.get(obs.device.type)
    if dtype is not None:
        leaves = tuple(x.to(dtype) for x in leaves)
    with_ckpt = torch.is_grad_enabled() and any(x.requires_grad for x in leaves)
    return PackedOp.apply(obs, seg_len, with_ckpt, *leaves).to(pi.dtype)


class PackedKernel(nn.Module):
    """Dense-transition likelihood kernel over a device-resident chunk tensor.

    data: int8 (N, L) chunks in {-1, 0, 1}.  M must be 16.  On a CUDA device
    the hand kernels run, in float32 (packed_op casts at the boundary); on
    the CPU their plain versions, in the parameters' dtype (see
    ops/packed.py).
    """

    def __init__(self, M: int, data, device="cpu", seg_len: int = packed.DEFAULT_SEG):
        super().__init__()
        if M != packed.M:
            raise ValueError(f"the packed kernel requires M={packed.M}, got {M}")
        data = np.asarray(data)
        self.M, self.L, self.seg_len = M, data.shape[-1], seg_len
        L_pad = -(-self.L // seg_len) * seg_len
        padded = np.pad(data, [(0, 0), (0, L_pad - self.L)], constant_values=-2)
        self.register_buffer("data", torch.as_tensor(padded, dtype=torch.int8, device=device))

    def loglik_batched(self, pp: PSMCParams, inds: torch.Tensor) -> torch.Tensor:
        """(B, S) log-likelihoods of chunks `inds` (S,); pp leaves (B, M)
        except pi, (B, S, M): the per-chunk initial distributions."""
        return self.loglik_rows(pp, self.data[inds])

    def loglik_rows(self, pp: PSMCParams, rows: torch.Tensor) -> torch.Tensor:
        "loglik_batched on rows (S, L') of `data`, padding included (a mesh fetches them)."
        return packed_op(dense_transition(pp), pp.emis0, pp.emis1, pp.pi, rows.contiguous(),
                         self.seg_len)
