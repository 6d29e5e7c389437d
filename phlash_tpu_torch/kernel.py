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
    "scan"     "scan"         the per-site O(M) forward of hmm.psmc_ll in
                              plain PyTorch (hmm.ScanKernel), differentiated
                              by autograd; no kernel of this package either

The CUDA kernels of "smc" and "packed" are float32-only: their ops cast
float64 inputs to float32 at the op boundary and the gradients back, and
double_precision=True (float64 kernel state) is refused for them, as
phlash_tpu refuses it for its TPU kernel.  "dense" and "scan" run in the
parameters' dtype, or in float64 with double_precision=True.  seg_len is the
dense backend's segment; the others have no segment grid (the SMC' and
packed kernels' tiles and period are fixed in csrc/*_common.cuh), so they
take only None and "auto" (phlash_tpu's autotune), both no-ops.
"""

from __future__ import annotations

import torch

from phlash_tpu_torch.hmm import ScanKernel
from phlash_tpu_torch.ops.build import load_library
from phlash_tpu_torch.ops.kernel_dense import DenseKernel
from phlash_tpu_torch.ops.kernel_packed import PackedKernel
from phlash_tpu_torch.ops.kernel_smc import SMCKernel

KERNELS = {"smc": SMCKernel, "packed": PackedKernel, "dense": DenseKernel, "scan": ScanKernel}
DEFAULT_BACKEND = "smc"
HAND_KERNELS = ("smc", "packed")  # the backends that launch this package's CUDA kernels


def resolve_device(device) -> torch.device:
    "A torch.device for `device`; a CUDA device must exist (no CPU fallback)."
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_backend(backend: str | None, overlap: int, double_precision: bool = False,
                  seg_len=None) -> str:
    """The backend name (None -> the default); raises ValueError for an
    unknown one, for "packed" with a warm-up prefix, which it cannot filter,
    for double_precision on the float32-only CUDA kernels, and for a segment
    length on a backend without segments."""
    backend = backend or DEFAULT_BACKEND
    if backend not in KERNELS:
        raise ValueError(f"unknown kernel backend {backend!r}; expected one of {sorted(KERNELS)}")
    if backend == "packed" and overlap > 0:
        raise ValueError(f"kernel_backend='packed' has no warm-up filter; it needs overlap=0, "
                         f"got overlap={overlap}")
    if double_precision and backend in HAND_KERNELS:
        raise ValueError(f"the {backend} kernels are float32-only; use backend='dense' or "
                         "'scan' for double_precision")
    if seg_len not in (None, "auto"):
        if backend != "dense":
            raise ValueError(f"kernel_seg_len={seg_len!r}: the {backend} backend has no segment "
                             "length (only 'dense' takes one)")
        if not isinstance(seg_len, int) or seg_len < 1:
            raise ValueError(f"kernel_seg_len must be a positive int or 'auto', got {seg_len!r}")
    return backend


def get_kernel(M: int, data, device="cuda", backend: str = None, double_precision: bool = False,
               seg_len=None):
    """Return the likelihood kernel for the int8 chunk tensor `data` (N, L).

    backend: "smc" (default), "packed", "dense" or "scan", see the module
    docstring, as are double_precision and seg_len.  On CUDA the kernel
    library is built here for the hand-kernel backends, so a build failure
    surfaces before the fit starts.
    """
    backend = check_backend(backend, 0, double_precision, seg_len)
    dev = resolve_device(device)
    if backend == "dense":
        return DenseKernel(M=M, data=data, device=dev, double_precision=double_precision,
                           seg_len=None if seg_len == "auto" else seg_len)
    if backend == "scan":
        return ScanKernel(M=M, data=data, device=dev, double_precision=double_precision)
    if dev.type == "cuda":
        load_library()
    return KERNELS[backend](M=M, data=data, device=dev)
