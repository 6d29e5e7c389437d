"""Likelihood-kernel dispatch.

Port of phlash_tpu/kernel.py:21-99.  `backend` chooses the algorithm,
`device` where it runs: a CUDA device gets the hand kernels, a CPU device
their plain PyTorch versions.  The names, beside phlash_tpu's:

    port       phlash_tpu     kernel
    "smc"      "pallas"       structured SMC' pair, B1-B3 (ops/kernel_smc.py);
                              the default
    "packed"   "pallas_mxu"   dense-transition pair, B4-B5
                              (ops/kernel_packed.py): M = 16, float32 on
                              CUDA, no filter_batched, so overlap 0 only
    "dense"    "dense"        dense-transition forward in plain PyTorch with
                              segment checkpointing (ops/kernel_dense.py);
                              no kernel of this package on either device

phlash_tpu's "scan" (hmm.PureXLAKernel) has no backend here.
"""

from __future__ import annotations

import torch

from phlash_tpu_torch.ops.build import load_library
from phlash_tpu_torch.ops.kernel_dense import DenseKernel
from phlash_tpu_torch.ops.kernel_packed import PackedKernel
from phlash_tpu_torch.ops.kernel_smc import SMCKernel

KERNELS = {"smc": SMCKernel, "packed": PackedKernel, "dense": DenseKernel}
DEFAULT_BACKEND = "smc"


def resolve_device(device) -> torch.device:
    "A torch.device for `device`; a CUDA device must exist (no CPU fallback)."
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_backend(backend: str | None, overlap: int) -> str:
    """The backend name (None -> the default); raises for an unknown one and
    for "packed" with a warm-up prefix, which it cannot filter."""
    backend = backend or DEFAULT_BACKEND
    if backend not in KERNELS:
        raise ValueError(f"unknown kernel backend {backend!r}; expected one of {sorted(KERNELS)}")
    if backend == "packed" and overlap > 0:
        raise ValueError(f"kernel_backend='packed' has no warm-up filter; it needs overlap=0, "
                         f"got overlap={overlap}")
    return backend


def get_kernel(M: int, data, device="cuda", backend: str = None):
    """Return the likelihood kernel for the int8 chunk tensor `data` (N, L).

    backend: "smc" (default), "packed" or "dense", see the module docstring.
    On CUDA the kernel library is built here for the hand-kernel backends,
    so a build failure surfaces before the fit starts.
    """
    backend = check_backend(backend, 0)
    dev = resolve_device(device)
    if dev.type == "cuda" and backend != "dense":
        load_library()
    return KERNELS[backend](M=M, data=data, device=dev)
