"""Likelihood-kernel dispatch.

Port of phlash_tpu/kernel.py:21-99 for the one backend the port has: the
structured SMC' kernel pair.  A CUDA device gets the hand kernels, a CPU
device their plain versions; any other combination raises.  With one
backend per device type, `backend` only restates what `device` implies; it
becomes a choice when a second backend for the same device lands (the
dense one, or B4/B5).
"""

from __future__ import annotations

import torch

from phlash_tpu_torch.ops.kernel_smc import SMCKernel

BACKENDS = {"cuda": "cuda", "plain": "cpu"}  # backend -> the device type it runs on


def resolve_device(device) -> torch.device:
    "A torch.device for `device`; a CUDA device must exist (no CPU fallback)."
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def get_kernel(M: int, data, device="cuda", backend: str = None) -> SMCKernel:
    """Return the likelihood kernel for the int8 chunk tensor `data` (N, L).

    backend: "cuda" (the hand kernels; needs a CUDA device) or "plain" (their
    plain PyTorch versions; CPU only).  None picks the one that matches
    `device`.  On CUDA the kernel library is built here, so a build failure
    surfaces before the fit starts.
    """
    dev = resolve_device(device)
    if backend is None:
        backend = "cuda" if dev.type == "cuda" else "plain"
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; expected one of {sorted(BACKENDS)}")
    if BACKENDS[backend] != dev.type:
        raise ValueError(f"kernel backend {backend!r} runs on {BACKENDS[backend]}, not on {dev}")
    if dev.type == "cuda":
        from phlash_tpu_torch.ops.build import load_library

        load_library()
    return SMCKernel(M=M, data=data, device=dev)
