"""Build and load the hand-written CUDA kernels.

`nvcc` compiles every source under phlash_tpu_torch/csrc/ into one shared
library with a plain C interface, which `ctypes` loads (no PyTorch headers,
so the build takes seconds).  The library lands in phlash_tpu_torch/_build/
(ignored by git) under a name keyed on a hash of the sources and the flags:
an edited kernel is rebuilt at first use, an unchanged one is reused.
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


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
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.phlash_smc_forward.argtypes = [P] * 8 + [I] * 4 + [P] * 4
    lib.phlash_smc_forward.restype = I
    lib.phlash_smc_backward.argtypes = [P] * 10 + [I] * 4 + [P] * 8
    lib.phlash_smc_backward.restype = I
    lib.phlash_cuda_error_string.argtypes = [I]
    lib.phlash_cuda_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=1)
def load_library() -> Library:
    "Build (if the sources changed) and load the kernel library, once per process."
    BUILD_DIR.mkdir(exist_ok=True)
    target = BUILD_DIR / f"libphlash_smc_{_digest()}.so"
    seconds, log = 0.0, ""
    if not target.exists():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        log = proc.stdout + proc.stderr
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    _declare(lib)
    return Library(lib=lib, path=target, build_seconds=seconds, ptxas_log=log)


def check(lib: Library, err: int, what: str) -> None:
    "Raise if a C entry point reported a CUDA error."
    if err != 0:
        msg = lib.lib.phlash_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
