"""Plain pair-coalescent HMM forward algorithm: the scan oracle and backend.

Port of phlash_tpu/hmm.py:29-123.  `matvec_smc` applies v @ A in O(M) from
the compressed SMC' structure; `psmc_ll` is the per-site-normalized forward
recursion at any dtype, with leading batch axes.  `psmc_ll` is the
independent per-site oracle that chip_smoke.py holds the plain structured
forward (phlash_tpu_torch.ops.smc) against at float64 on the card, before
that plain version gates the CUDA kernels.  `psmc_ll_dm` takes a
demographic model.  `ScanKernel` (phlash_tpu's PureXLAKernel) puts
`psmc_ll` behind the kernel interface as kernel_backend="scan": plain
PyTorch on either device, differentiated by autograd through the site loop.
Padding (-2) freezes the state, as it does in the kernels (the JAX oracle is
only ever given {-1, 0, 1}).
"""

from __future__ import annotations

import torch

from phlash_tpu_torch.kernel_base import LikelihoodKernel, upload
from phlash_tpu_torch.params import PSMC_FIELDS, PSMCParams
from phlash_tpu_torch.size_history import DemographicModel


def matvec_smc(v: torch.Tensor, pp: PSMCParams) -> torch.Tensor:
    """v @ A over the last axis:
    out[j] = b[j] * sum_{i>j} v[i] + d[j] * v[j] + v_col[j] * sum_{i<j} u[i] v[i]."""
    zero = torch.zeros_like(v[..., :1])
    suffix = torch.cat([v[..., 1:].flip(-1).cumsum(-1).flip(-1), zero], -1)
    prefix = torch.cat([zero, torch.cumsum(pp.u * v, -1)[..., :-1]], -1)
    return suffix * pp.b + pp.d * v + prefix * pp.v


def psmc_ll(pp: PSMCParams, data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scaled forward algorithm over observation sequences.

    pp leaves (..., M); data (..., L) int8 in {-2 padding, -1 missing,
    0 hom, 1 het}, broadcast against pp's batch axes.
    Returns (filtered distribution at the final site (..., M), log-likelihood (...)).
    """
    alpha = pp.pi
    ll = torch.zeros(alpha.shape[:-1], dtype=alpha.dtype, device=alpha.device)
    one = torch.ones_like(pp.emis0)
    for t in range(data.shape[-1]):
        ob = data[..., t, None]
        f = torch.where(ob == 0, pp.emis0, torch.where(ob == 1, pp.emis1, one))
        a = matvec_smc(alpha, pp) * f
        norm = torch.clamp_min(a.sum(-1, keepdim=True), 1e-35)
        live = ob != -2
        alpha = torch.where(live, a / norm, alpha)
        ll = ll + torch.where(live[..., 0], torch.log(norm[..., 0]), torch.zeros_like(ll))
    return alpha, ll


def psmc_ll_dm(dm: DemographicModel, data: torch.Tensor):
    "psmc_ll under the HMM parameters of a demographic model."
    return psmc_ll(PSMCParams.from_dm(dm), data)


class ScanKernel(LikelihoodKernel):
    """The scan likelihood kernel over a device-resident chunk tensor.

    data: int8 (N, L) chunks in {-1, 0, 1}, placed on `device` (cuda unless
    asked for the CPU).  The same interface as ops/kernel_smc.SMCKernel and
    ops/kernel_dense.DenseKernel (kernel_base.py); plain PyTorch on either
    device, in the parameters' dtype, or in float64 with
    double_precision=True.
    """

    def __init__(self, M: int, data, device="cuda", double_precision: bool = False):
        super().__init__()
        self.M = M
        self.double_precision = double_precision
        self.register_buffer("data", upload(data, device))

    def loglik_rows(self, pp: PSMCParams, rows: torch.Tensor) -> torch.Tensor:
        "loglik_batched on the body rows (S, L) themselves (a mesh fetches them, see parallel/)."
        if self.double_precision:
            pp = pp.to(torch.float64)
        per_chunk = pp.replace(**{k: getattr(pp, k)[:, None, :] for k in PSMC_FIELDS if k != "pi"})
        return psmc_ll(per_chunk, rows)[1]

    def filter_batched(self, pp: PSMCParams, warmup: torch.Tensor) -> torch.Tensor:
        """Filtered state after the warmup prefixes, (B, S, M), differentiable.
        pp leaves (B, M); warmup (S, overlap) int8, shared across particles."""
        if self.double_precision:
            pp = pp.to(torch.float64)
        S = warmup.shape[0]
        per_chunk = PSMCParams(*(getattr(pp, k)[:, None, :] for k in PSMC_FIELDS))
        per_chunk = per_chunk.replace(pi=per_chunk.pi.expand(-1, S, -1))
        return psmc_ll(per_chunk, warmup.to(torch.int8))[0]
