"""Build and load the hand-written CUDA kernels.

`nvcc` compiles every source under phlash_tpu_torch/csrc/ to an object,
one process per source, all started together, and links the objects into
one shared library with a plain C interface, which `ctypes` loads (no
PyTorch headers, so the build takes seconds).  The library lands in
phlash_tpu_torch/_build/ (ignored by git) under a name keyed on a hash of
the sources and the flags: an edited kernel is rebuilt at first use, an
unchanged one is reused.
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a source's own flags beside NVCC_FLAGS: the assembly rounds every operation as its plain
# version (separate ATen kernels) does, so its float32 gradient, which is ill-conditioned in
# some forward values, keeps the plain version's accuracy (csrc/assembly_common.cuh)
SOURCE_FLAGS = {"assembly.cu": ("--fmad=false",)}
# the dtype the HMM kernels of a device type take: the CUDA kernels B1-B5
# are float32-only; the plain versions (every other device) take any dtype.
# The assembly kernels (ops/assembly.py) take float32 and float64 alike.
KERNEL_DTYPE = {"cuda": torch.float32}


@dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    ptxas_log: str  # per-kernel registers / local memory, as ptxas reports them


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.phlash_smc_forward.argtypes = [P] * 9 + [I] * 4 + [P] * 4
    lib.phlash_smc_forward.restype = I
    lib.phlash_smc_backward.argtypes = [P] * 11 + [I] * 4 + [P] * 8
    lib.phlash_smc_backward.restype = I
    lib.phlash_smc_forward_split.argtypes = [P] * 9 + [I] * 6 + [P] * 10
    lib.phlash_smc_forward_split.restype = I
    lib.phlash_smc_backward_split.argtypes = [P] * 11 + [I] * 7 + [P] * 14
    lib.phlash_smc_backward_split.restype = I
    lib.phlash_smc_live_periods.argtypes = [P] + [I] * 3 + [P] * 3
    lib.phlash_smc_live_periods.restype = I
    lib.phlash_smc_check_every.argtypes = []
    lib.phlash_smc_check_every.restype = I
    lib.phlash_smc_states_per_lane.argtypes = [I]
    lib.phlash_smc_states_per_lane.restype = I
    lib.phlash_smc_instances_per_block.argtypes = []
    lib.phlash_smc_instances_per_block.restype = I
    lib.phlash_smc_adjoint_split_blocks_per_sm.argtypes = [I, I]
    lib.phlash_smc_adjoint_split_blocks_per_sm.restype = I
    lib.phlash_packed_forward.argtypes = [P] * 5 + [I] * 3 + [P] * 3
    lib.phlash_packed_forward.restype = I
    lib.phlash_packed_backward.argtypes = [P] * 6 + [I] * 3 + [P] * 5
    lib.phlash_packed_backward.restype = I
    lib.phlash_packed_forward_split.argtypes = [P] * 5 + [I] * 5 + [P] * 12
    lib.phlash_packed_forward_split.restype = I
    lib.phlash_packed_backward_split.argtypes = [P] * 6 + [I] * 5 + [P] * 14
    lib.phlash_packed_backward_split.restype = I
    lib.phlash_packed_period.argtypes = []
    lib.phlash_packed_period.restype = I
    lib.phlash_packed_states_per_lane.argtypes = [I]
    lib.phlash_packed_states_per_lane.restype = I
    D = ctypes.c_double
    lib.phlash_assembly_forward.argtypes = [I] + [P] * 5 + [I] * 5 + [D] * 3 + [P] * 4
    lib.phlash_assembly_forward.restype = I
    lib.phlash_assembly_backward.argtypes = [I] + [P] * 5 + [I] * 5 + [D] * 3 + [P] * 5
    lib.phlash_assembly_backward.restype = I
    lib.phlash_assembly_geometry.argtypes = [I] * 5 + [P]
    lib.phlash_assembly_geometry.restype = I
    lib.phlash_peak.argtypes = [I] * 3 + [P] * 3 + [I] * 3 + [P] * 2
    lib.phlash_peak.restype = I
    lib.phlash_svgd_distances.argtypes = [I] + [P] * 2 + [I] * 2 + [P] * 6
    lib.phlash_svgd_distances.restype = I
    lib.phlash_svgd_bandwidth.argtypes = [I, P, P, I, D] + [P] * 5
    lib.phlash_svgd_bandwidth.restype = I
    lib.phlash_svgd_update.argtypes = [I] + [P] * 4 + [I] * 4 + [P] * 4 + [D] * 4 + [P] * 6
    lib.phlash_svgd_update.restype = I
    lib.phlash_svgd_geometry.argtypes = [I, I, P]
    lib.phlash_svgd_geometry.restype = I
    lib.phlash_cuda_error_string.argtypes = [I]
    lib.phlash_cuda_error_string.restype = ctypes.c_char_p


def _run(procs) -> str:
    "Wait for every nvcc process; their output, or RuntimeError if one failed."
    outs = [(proc, *proc.communicate()) for proc in procs]
    for proc, out, err in outs:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {proc.args}\n{out}{err}")
    return "".join(out + err for _, out, err in outs)


def _build(target: Path) -> str:
    "Compile the sources in parallel, link them into `target`; the ptxas log."
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        log = _run([
            subprocess.Popen([nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c", str(src),
                              "-o", str(obj)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(_sources(), objs)
        ])
        lib = Path(tmp) / target.name
        _run([subprocess.Popen([nvcc, *ARCH, "-shared", "-o", str(lib), *map(str, objs)],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)])
        os.replace(lib, target)
    return log


@functools.lru_cache(maxsize=1)
def load_library() -> Library:
    "Build (if the sources changed) and load the kernel library, once per process."
    BUILD_DIR.mkdir(exist_ok=True)
    target = BUILD_DIR / f"libphlash_kernels_{_digest()}.so"
    seconds, log = 0.0, ""
    if not target.exists():
        t0 = time.perf_counter()
        log = _build(target)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    _declare(lib)
    return Library(lib=lib, path=target, build_seconds=seconds, ptxas_log=log)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    "A tensor's device address for a C entry point (null for None)."
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def require_cuda(floats, ints8=()) -> torch.device:
    "Validate what the kernels take: one CUDA device, contiguous float32 / int8."
    dev = floats[0].device
    for t in floats:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"the CUDA kernels take contiguous float32 tensors on one CUDA device, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    for t in ints8:
        if t.device != dev or t.dtype != torch.int8 or not t.is_contiguous():
            raise ValueError(f"observation rows must be contiguous int8 on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {dev}")
    return dev


def stream(dev: torch.device) -> ctypes.c_void_p:
    "PyTorch's current stream on `dev`, for a launch."
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def check(lib: Library, err: int, what: str) -> None:
    "Raise if a C entry point reported a CUDA error."
    if err != 0:
        msg = lib.lib.phlash_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
