"""Dense reconstruction of the compressed SMC' transition.

Port of phlash_tpu/ops/packing.py:23-30.  The compressed PSMCParams
(b, d, u, v) describe the M x M transition matrix

    A[i, j] = b[j] * 1{i > j}  +  d[j] * 1{i == j}  +  u[i] v[j] * 1{i < j},

which the dense-transition kernels (ops/kernel_dense.py, ops/kernel_packed.py)
consume.  The TPU's block-diagonal MXU packing (`block_diag_pack`) has no
counterpart: the port's packed kernel keeps one 16 x 16 matrix per particle.
"""

from __future__ import annotations

import torch

from phlash_tpu_torch.params import PSMCParams


def dense_transition(pp: PSMCParams) -> torch.Tensor:
    """(..., M, M) transition matrices from leaves (..., M), batched over the
    leading axes; elementwise only, so autograd carries dA back to b, d, u, v."""
    M = pp.d.shape[-1]
    i = torch.arange(M, device=pp.d.device)
    lower = (i[:, None] > i[None, :]).to(pp.b.dtype)
    upper = (i[:, None] < i[None, :]).to(pp.b.dtype)
    return (pp.b[..., None, :] * lower + torch.diag_embed(pp.d)
            + pp.u[..., :, None] * pp.v[..., None, :] * upper)
