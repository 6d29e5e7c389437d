"""ctypes binding for the C VCF genotype tokenizer (_fastvcf.c).

Port of phlash_tpu/io/fastvcf.py.  The shared library is compiled at first
use with the system C compiler (`cc -O3 -shared -fPIC`) into
phlash_tpu_torch/_build/, under a name keyed on a hash of the source, and
moved into place with os.replace, so processes that build at once never
load a half-written file.  When no compiler works, vcf_parser_backend()
says "python" and phlash_tpu_torch.data parses VCF text in Python.
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "_fastvcf.c"
BUILD_DIR = SRC.parent.parent / "_build"
CFLAGS = ("-O3", "-shared", "-fPIC")


def _target() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libphlash_fastvcf_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> bool:
    "Compile the tokenizer into `target`; False when no compiler succeeds."
    BUILD_DIR.mkdir(exist_ok=True)
    for cc in ("cc", "gcc", "clang"):
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        try:
            subprocess.run([cc, *CFLAGS, "-o", tmp, str(SRC)], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, target)
            return True
        except (OSError, subprocess.SubprocessError) as e:
            logger.debug("fastvcf build with %s failed: %s", cc, e)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return False


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL | None:
    "The tokenizer library, built if needed, once per process; None if it cannot be."
    target = _target()
    try:
        if not target.exists() and not _build(target):
            logger.info("fastvcf C extension unavailable; using the Python VCF parser")
            return None
    except OSError as e:  # e.g. a read-only checkout
        logger.info("fastvcf C extension unavailable (%s); using the Python VCF parser", e)
        return None
    lib = ctypes.CDLL(str(target))
    lib.phlash_parse_vcf.restype = ctypes.c_long
    lib.phlash_parse_vcf.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_long,
    ]
    return lib


def vcf_parser_backend() -> str:
    "'c' when the native tokenizer is available, else 'python'."
    return "c" if _load() is not None else "python"


def parse_vcf_lines(text: bytes, sample_cols: list[int], contig: str = None,
                    max_records: int = None):
    """Tokenize VCF body text with the C extension.

    Args:
        text: raw VCF body bytes (header lines starting with '#' are skipped).
        sample_cols: 0-based tab-column indices of the requested samples,
            ascending.
        contig: only keep records whose CHROM equals this (None = all).
        max_records: output capacity (default: number of newlines).

    Returns:
        (pos int64 (R,), het int8 (R, S), nd int32 (R,)) or None when the
        native backend is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    if max_records is None:
        max_records = text.count(b"\n") + 1
    S = len(sample_cols)
    cols = np.asarray(sorted(sample_cols), dtype=np.int64)
    pos = np.empty(max_records, dtype=np.int64)
    het = np.empty((max_records, S), dtype=np.int8)
    nd = np.empty(max_records, dtype=np.int32)
    cb = contig.encode() if contig else b""
    n = lib.phlash_parse_vcf(
        text, len(text), cb, len(cb), cols, S, pos, het.reshape(-1), nd, max_records
    )
    return pos[:n], het[:n], nd[:n]
