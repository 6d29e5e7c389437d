"""Structured-SMC' likelihood kernel: autograd wrapper and kernel module.

Port of phlash_tpu/ops/kernel_smc.py.  `SMCOp` is the torch.autograd.Function
that replaces the JAX custom VJP (kernel_smc.py:69-99): its forward runs the
forward kernel (with the period residuals only when a gradient is wanted),
its backward runs the adjoint with the ll cotangent and the final-state
cotangent, so the likelihood and the warmup filter share one kernel pair.
Its backward sums each particle's gradients over the chunks;
`instance_grads` runs the same pair outside autograd and keeps them per
chunk.  `SMCKernel` owns the device-resident int8 chunk tensor and exposes
`loglik_batched` and `filter_batched` as in phlash_tpu, and the
per-particle entries of kernel_base.py.

The fit's density (`model_loglik_rows`: the step's likelihood and the
held-out ELPD) takes parameters from demographic models and discards the
final state, so it runs each row to its live end only (`trim`; ops/smc.py
says why that is the same likelihood and the same gradient of the model's
parameters).  The phlash_tpu entries (`loglik_rows`, `loglik_batched`,
`kern(pp, index, grad)`) take any PSMCParams, whose transition need not be
row-stochastic, and the warm-up filter reads its final state: they run
whole rows.
"""

from __future__ import annotations

import torch

from phlash_tpu_torch.kernel_base import LikelihoodKernel, kernel_dtype, one_particle, upload
from phlash_tpu_torch.ops import smc
from phlash_tpu_torch.params import PSMCParams

_PARAMS = ("b", "d", "u", "v", "emis0", "emis1")


def _forward(leaves, obs, with_residuals: bool, trim: bool):
    """B1 (B2 with the period residuals) from 6 x (B, M), pi: ll (B, S),
    alpha (B, S, M), pstates, and the rows' live ends where `trim` (each row
    then runs to its end, and alpha is the state there), else None."""
    *params, pi = (x.contiguous() for x in leaves)
    live = smc.live_periods(obs, pi.shape[0]) if trim else None
    return (*smc.forward(tuple(params), pi, obs, with_residuals, live), live)


def _adjoint(params, obs, pstates, g_ll, g_alpha, live):
    """B3: the per-instance gradients (6 x (B, S, M), dpi (B, S, M)), which
    SMCOp's backward sums over the chunks and instance_grads keeps."""
    return smc.backward(tuple(x.contiguous() for x in params), obs, pstates,
                        g_ll.contiguous(), g_alpha.contiguous(), live)


def _kernel_leaves(pp: PSMCParams, pi: torch.Tensor, obs: torch.Tensor) -> tuple:
    "pp's six leaves and pi, cast to the kernels' dtype (kernel_base.kernel_dtype)."
    return kernel_dtype([getattr(pp, k) for k in _PARAMS] + [pi], obs.device)


class SMCOp(torch.autograd.Function):
    """(ll (B, S), final state (B, S, M)) from per-particle params and
    per-instance pi; with `trim` each row runs to its live end, and the
    state is the one there."""

    @staticmethod
    def forward(ctx, obs, with_residuals, trim, *leaves):
        ll, alpha, pstates, live = _forward(leaves, obs, with_residuals, trim)
        if with_residuals:
            ctx.save_for_backward(obs, pstates, live, *leaves[:-1])
        return ll, alpha

    @staticmethod
    def backward(ctx, g_ll, g_alpha):
        # only reached when forward kept residuals; an unused output's
        # cotangent arrives as zeros (materialized grads)
        obs, pstates, live, *params = ctx.saved_tensors
        dparams, dpi = _adjoint(params, obs, pstates, g_ll, g_alpha, live)
        return (None, None, None, *(x.sum(1) for x in dparams), dpi)


def smc_op(pp: PSMCParams, pi: torch.Tensor, obs: torch.Tensor, trim: bool = False):
    """Run the kernel pair: pp leaves (B, M) (pp.pi is ignored), pi (B, S, M),
    obs (S, L) int8 rows; with `trim` each row to its live end only (the
    returned state is then the one there).  Residuals are kept only when
    autograd will ask.  The inputs are cast to the kernels' dtype (autograd
    casts their gradients back) and the outputs to pi's dtype."""
    leaves = _kernel_leaves(pp, pi, obs)
    with_residuals = torch.is_grad_enabled() and any(x.requires_grad for x in leaves)
    ll, alpha = SMCOp.apply(obs, with_residuals, trim, *leaves)
    return ll.to(pi.dtype), alpha.to(pi.dtype)


def smc_instance_grads(pp: PSMCParams, obs: torch.Tensor):
    """(ll (n,), each chunk's gradient of pp's leaves, (n, M) each) for one
    particle pp, unbatched leaves, on the rows obs (n, L): one forward with
    residuals (B2) and one adjoint (B3) at (B, S) = (1, n), outside
    autograd, cast as smc_op casts."""
    one = one_particle(pp, obs.shape[0])
    leaves = _kernel_leaves(one, one.pi, obs)
    ll, _, pstates, _ = _forward(leaves, obs, True, False)
    dparams, dpi = _adjoint(leaves[:-1], obs, pstates, torch.ones_like(ll),
                            torch.zeros_like(leaves[-1]), None)
    dtype = pp.pi.dtype
    return ll[0].to(dtype), PSMCParams(*(x[0].to(dtype) for x in (*dparams, dpi)))


class SMCKernel(LikelihoodKernel):
    """Structured likelihood kernel over a device-resident chunk tensor.

    data: int8 (N, L) chunks in {-1, 0, 1}, placed on `device` (cuda unless
    asked for the CPU).  On a CUDA device the hand kernels run; on the CPU
    their plain versions (see ops/smc.py).
    """

    def __init__(self, M: int, data, device="cuda"):
        super().__init__()
        if M not in smc.SUPPORTED_M:
            raise ValueError(f"the SMC kernels support M in {smc.SUPPORTED_M}, got {M}")
        self.M = M
        self.register_buffer("data", upload(data, device))

    def instance_grads(self, pp: PSMCParams, rows: torch.Tensor):
        return smc_instance_grads(pp, rows.contiguous())

    def loglik_rows(self, pp: PSMCParams, rows: torch.Tensor) -> torch.Tensor:
        "loglik_batched on the body rows (S, L) themselves (a mesh fetches them, see parallel/)."
        ll, _ = smc_op(pp, pp.pi, rows.contiguous())
        return ll

    def model_loglik_rows(self, pp: PSMCParams, rows: torch.Tensor) -> torch.Tensor:
        "loglik_rows with each row run to its live end (pp from demographic models)."
        ll, _ = smc_op(pp, pp.pi, rows.contiguous(), trim=True)
        return ll

    def filter_batched(self, pp: PSMCParams, warmup: torch.Tensor) -> torch.Tensor:
        """Filtered state after the warmup prefixes, (B, S, M), differentiable.
        pp leaves (B, M); warmup (S, overlap) int8, shared across particles."""
        S = warmup.shape[0]
        pi = pp.pi[:, None, :].expand(-1, S, -1)
        _, alpha = smc_op(pp, pi, warmup.to(torch.int8).contiguous())
        return alpha
