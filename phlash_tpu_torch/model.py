"""Composite log-density: prior + chunked HMM likelihood + AFS likelihood.

Port of phlash_tpu/model.py:32-41,91-145.  `log_density_batched` expands the
particles' coordinates to HMM natural parameters once, filters each chunk's
overlap prefix through the kernel to get per-chunk initial distributions,
evaluates the chunk log-likelihoods through the same kernel, adds the AFS
term, and combines with weights c = [prior, HMM, AFS] (the fit uses
[1, N/S, 1], so minibatch gradients are unbiased).  Particles are
independent, so one backward pass of the summed densities gives every
particle's gradient.
"""

from __future__ import annotations

import math

import torch

from phlash_tpu_torch.params import MCMCParams, PSMCParams
from phlash_tpu_torch.size_history import SizeHistory


def log_prior(mcp: MCMCParams) -> torch.Tensor:
    """Per-particle log prior: standard normal on log(rho/theta), an
    alpha-weighted smoothness penalty on log c, a beta-weighted ridge."""
    x = torch.log(mcp.rho_over_theta)
    lp = -(math.log(2.0 * math.pi) + x**2) / 2.0
    lp = lp - mcp.alpha * (torch.diff(mcp.log_c) ** 2).sum(-1)
    flat = mcp.flatten()
    return lp - mcp.beta * (flat * flat).sum(-1)


def log_afs(eta: SizeHistory, afs: torch.Tensor, afs_transform: torch.Tensor | None = None
            ) -> torch.Tensor:
    """(B,) AFS composite log-likelihood of the observed (n-1,) spectrum under
    each history's expected spectrum, both through afs_transform (identity
    when None), in the dtype of eta."""
    n = afs.shape[-1] + 1
    dtype = eta.c.dtype
    T = (torch.eye(n - 1, dtype=dtype, device=eta.c.device)
         if afs_transform is None else afs_transform.to(dtype))
    T_afs = T @ afs.to(dtype)  # constant across particles
    etbl = eta.etbl(n)  # (B, n-1)
    esfs = etbl / etbl.sum(-1, keepdim=True)
    return torch.special.xlogy(T_afs, (T * esfs[:, None, :]).sum(-1)).sum(-1)


def log_density_rows(
    mcps: MCMCParams,  # leaves with a leading particle axis B
    c,  # (3,) weights: prior, HMM, AFS
    warmup: torch.Tensor,  # (S, overlap) int8 prefix observations
    rows: torch.Tensor,  # (S, L) int8 body rows of the kernel's data
    kern,  # a kernel of kernel.get_kernel
    afs: torch.Tensor | None,  # (n-1,) observed spectrum, or None
    afs_transform: torch.Tensor | None = None,
    prior_and_afs: bool = True,
) -> torch.Tensor:
    """(B,) weighted log-densities on the given chunk rows, unmasked.  With
    prior_and_afs=False only the chunks' likelihood term: a rank of a mesh's
    chunk axis other than the first (parallel/mesh.py) adds just its share."""
    dms = mcps.to_dm()
    pp = PSMCParams.from_dm(dms)  # leaves (B, M)

    S = warmup.shape[0]
    if S == 0:  # a mesh rank with no share of this minibatch
        l_hmm = torch.zeros_like(pp.pi[:, 0])
    else:
        if warmup.shape[1] == 0:  # no prefix context: pi passes through
            pis = pp.pi[:, None, :].expand(-1, S, -1)
        else:
            pis = kern.filter_batched(pp, warmup)  # (B, S, M)
        l_hmm = kern.loglik_rows(pp.replace(pi=pis), rows).sum(1)
    if not prior_and_afs:
        return c[1] * l_hmm

    l_prior = log_prior(mcps)
    if afs is not None:
        l_afs = log_afs(dms.eta, afs, afs_transform)
    else:
        l_afs = torch.zeros_like(l_prior)
    return c[0] * l_prior + c[1] * l_hmm + c[2] * l_afs


def log_density_batched(
    mcps: MCMCParams,  # leaves with a leading particle axis B
    c,  # (3,) weights: prior, HMM, AFS
    inds: torch.Tensor,  # (S,) minibatch chunk indices
    warmup: torch.Tensor,  # (S, overlap) int8 prefix observations
    kern,  # a kernel of kernel.get_kernel
    afs: torch.Tensor | None,  # (n-1,) observed spectrum, or None
    afs_transform: torch.Tensor | None = None,
) -> torch.Tensor:
    "(B,) weighted log-densities; -inf where any component is non-finite."
    total = log_density_rows(mcps, c, warmup, kern.data[inds], kern, afs, afs_transform)
    return torch.where(torch.isfinite(total), total, torch.full_like(total, -math.inf))
