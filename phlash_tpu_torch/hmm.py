"""Plain pair-coalescent HMM forward algorithm: the scan oracle.

Port of phlash_tpu/hmm.py:29-68.  `matvec_smc` applies v @ A in O(M) from the
compressed SMC' structure; `psmc_ll` is the per-site-normalized forward
recursion at any dtype, with leading batch axes.  Neither is on the fit
path: `psmc_ll` is the independent per-site oracle that chip_smoke.py holds
the plain structured forward (phlash_tpu_torch.ops.smc) against at float64
on the card, before that plain version gates the CUDA kernels.  Padding
(-2) freezes the state, as it does in the kernels (the JAX oracle is only
ever given {-1, 0, 1}).
"""

from __future__ import annotations

import torch

from phlash_tpu_torch.params import PSMCParams


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
