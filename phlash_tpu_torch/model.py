"""Composite log-density: prior + chunked HMM likelihood + AFS likelihood.

Port of phlash_tpu/model.py:32-41,91-145.  `log_density_batched` expands the
particles' coordinates to HMM natural parameters, the log prior and the AFS
term in one op (ops/assembly.AssemblyOp: the hand kernels A1 / A2 on the
card; on the CPU the params / transition code and ops/assembly's
`log_prior` and `log_afs`, which this module re-exports),
filters each chunk's overlap prefix through the kernel to get per-chunk
initial distributions, evaluates the chunk log-likelihoods through the same
kernel, and combines with weights c = [prior, HMM, AFS] (the fit uses
[1, N/S, 1], so minibatch gradients are unbiased).  Particles are
independent, so one backward pass of the summed densities gives every
particle's gradient.
"""

from __future__ import annotations

import math

import torch

from phlash_tpu_torch.ops import assembly
from phlash_tpu_torch.ops.assembly import log_afs, log_prior  # noqa: F401  (the plain terms)
from phlash_tpu_torch.params import MCMCParams


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
    pp, l_prior, l_afs = assembly.assemble(mcps, afs, afs_transform)  # leaves (B, M)

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
