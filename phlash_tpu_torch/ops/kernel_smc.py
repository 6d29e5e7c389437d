"""Structured-SMC' likelihood kernel: autograd wrapper and kernel module.

Port of phlash_tpu/ops/kernel_smc.py.  `SMCOp` is the torch.autograd.Function
that replaces the JAX custom VJP (kernel_smc.py:69-99): its forward runs the
forward kernel (with the period residuals only when a gradient is wanted),
its backward runs the adjoint with the ll cotangent and the final-state
cotangent, so the likelihood and the warmup filter share one kernel pair.
`SMCKernel` owns the device-resident int8 chunk tensor and exposes
`loglik_batched` and `filter_batched` as in phlash_tpu.
"""

from __future__ import annotations

import torch
from torch import nn

from phlash_tpu_torch.ops import build, smc
from phlash_tpu_torch.params import PSMCParams

_PARAMS = ("b", "d", "u", "v", "emis0", "emis1")


class SMCOp(torch.autograd.Function):
    "(ll (B, S), final state (B, S, M)) from per-particle params and per-instance pi."

    @staticmethod
    def forward(ctx, obs, with_residuals, b, d, u, vv, e0, e1, pi):
        params = tuple(x.contiguous() for x in (b, d, u, vv, e0, e1))
        ll, alpha, pstates = smc.forward(params, pi.contiguous(), obs, with_residuals)
        if with_residuals:
            ctx.save_for_backward(obs, pstates, *params)
        return ll, alpha

    @staticmethod
    def backward(ctx, g_ll, g_alpha):
        # only reached when forward kept residuals; an unused output's
        # cotangent arrives as zeros (materialized grads)
        obs, pstates, *params = ctx.saved_tensors
        dparams, dpi = smc.backward(
            tuple(params), obs, pstates, g_ll.contiguous(), g_alpha.contiguous()
        )
        return (None, None, *(x.sum(1) for x in dparams), dpi)


def smc_op(pp: PSMCParams, pi: torch.Tensor, obs: torch.Tensor):
    """Run the kernel pair: pp leaves (B, M) (pp.pi is ignored), pi (B, S, M),
    obs (S, L) int8 rows.  Residuals are kept only when autograd will ask.
    The kernels take build.KERNEL_DTYPE (float32 on CUDA): the inputs are
    cast to it here (autograd casts their gradients back) and the outputs to
    pi's dtype, so a float64 tensor never reaches a kernel."""
    leaves = [getattr(pp, k) for k in _PARAMS] + [pi]
    dtype = build.KERNEL_DTYPE.get(obs.device.type)
    if dtype is not None:
        leaves = [x.to(dtype) for x in leaves]
    with_residuals = torch.is_grad_enabled() and any(x.requires_grad for x in leaves)
    ll, alpha = SMCOp.apply(obs, with_residuals, *leaves)
    return ll.to(pi.dtype), alpha.to(pi.dtype)


class SMCKernel(nn.Module):
    """Structured likelihood kernel over a device-resident chunk tensor.

    data: int8 (N, L) chunks in {-1, 0, 1}.  On a CUDA device the hand
    kernels run; on the CPU their plain versions (see ops/smc.py).
    """

    def __init__(self, M: int, data, device="cpu"):
        super().__init__()
        if M not in smc.SUPPORTED_M:
            raise ValueError(f"the SMC kernels support M in {smc.SUPPORTED_M}, got {M}")
        self.M = M
        self.register_buffer("data", torch.as_tensor(data, dtype=torch.int8, device=device))

    def loglik_batched(self, pp: PSMCParams, inds: torch.Tensor) -> torch.Tensor:
        """(B, S) log-likelihoods of chunks `inds` (S,); pp leaves (B, M)
        except pi, (B, S, M): the per-chunk initial distributions."""
        return self.loglik_rows(pp, self.data[inds])

    def loglik_rows(self, pp: PSMCParams, rows: torch.Tensor) -> torch.Tensor:
        "loglik_batched on the body rows (S, L) themselves (a mesh fetches them, see parallel/)."
        ll, _ = smc_op(pp, pp.pi, rows.contiguous())
        return ll

    def filter_batched(self, pp: PSMCParams, warmup: torch.Tensor) -> torch.Tensor:
        """Filtered state after the warmup prefixes, (B, S, M), differentiable.
        pp leaves (B, M); warmup (S, overlap) int8, shared across particles."""
        S = warmup.shape[0]
        pi = pp.pi[:, None, :].expand(-1, S, -1)
        _, alpha = smc_op(pp, pi, warmup.to(torch.int8).contiguous())
        return alpha
