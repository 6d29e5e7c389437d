"""Data ingestion for the port: .psmcfa contigs -> int8 chunk tensors + AFS.

Numpy copies of the parts of phlash_tpu/data.py the fit path runs
(`chunk_het_matrix` :45-63, `RawContig` with `from_psmcfa_iter` :114-151,
`_iter_fasta` :153-169, a single-process `init_mcmc_data` :709-757);
importing phlash_tpu.data would load JAX.  Values are {-1 missing, 0 hom,
1 het}.
"""

from __future__ import annotations

import gzip
import logging
from dataclasses import dataclass
from typing import Iterable

import numpy as np

logger = logging.getLogger(__name__)


def chunk_het_matrix(het_matrix: np.ndarray, overlap: int, chunk_size: int) -> np.ndarray:
    """Slice each row into overlapping chunks of length overlap + chunk_size.

    Consecutive chunks advance by `chunk_size`, so each chunk's first
    `overlap` columns replay the tail of its predecessor: the warmup prefix
    that localizes the filtering distribution.  Padding with -1 (missing)
    keeps shapes static.
    """
    data = het_matrix.clip(-1, 1).astype(np.int8)
    assert data.ndim == 2
    N, L = data.shape
    span = chunk_size + overlap
    n_chunks = max(1, -(-L // span))
    padded = np.pad(data, [[0, 0], [0, n_chunks * span - L]], constant_values=-1)
    cols = np.arange(n_chunks)[:, None] * chunk_size + np.arange(span)[None, :]
    return padded[:, cols].reshape(-1, span)


@dataclass(frozen=True)
class RawContig:
    "A contig whose het matrix and AFS are already computed."

    het_matrix: np.ndarray  # int8 (rows, windows)
    afs: np.ndarray | None  # (n - 1,)
    window_size: int

    @classmethod
    def from_psmcfa_iter(cls, psmcfa_path: str, window_size: int = 100) -> Iterable["RawContig"]:
        """Parse a PSMC FASTA (.psmcfa) file: 'K' = het window, 'T' = hom,
        'N' = missing (.gz too)."""
        for name, seq in _iter_fasta(psmcfa_path):
            logger.debug("read contig %s from %s", name, psmcfa_path)
            arr = np.frombuffer(seq.encode(), dtype="S1")
            data = (arr == b"K").astype(np.int8)
            data[arr == b"N"] = -1
            yield cls(het_matrix=data[None], afs=np.ones(1), window_size=window_size)

    @property
    def L(self):
        "Sequence length in base pairs."
        return self.het_matrix.shape[1] * self.window_size

    def get_data(self, window_size: int) -> dict:
        if window_size != self.window_size:
            raise ValueError(
                f"contig was built with window_size={self.window_size}, requested {window_size}"
            )
        return dict(het_matrix=self.het_matrix, afs=self.afs)


def _iter_fasta(path: str):
    "Minimal FASTA reader yielding (name, sequence) pairs."
    opener = gzip.open if path.endswith(".gz") else open
    name, parts = None, []
    with opener(path, "rt") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(parts)
                name, parts = line[1:].split()[0], []
            else:
                parts.append(line)
        if name is not None:
            yield name, "".join(parts)


def init_mcmc_data(data: list[RawContig], window_size: int, overlap: int, chunk_size: int = None):
    """Chunk every contig; return (summed AFS or None, stacked int8 chunks).

    chunk_size defaults to ~1/5 of the shortest contig (in windows).
    """
    if chunk_size is None:
        chunk_size = int(min(0.2 * ds.L / window_size for ds in data))
    if chunk_size < 10 * overlap:
        logger.warning("chunk size %d is less than 10x the overlap (%d)", chunk_size, overlap)
    afss, blocks = [], []
    for ds in data:
        d = ds.get_data(window_size)
        if d["afs"] is not None:
            afss.append(d["afs"])
        blocks.append(chunk_het_matrix(d["het_matrix"], overlap=overlap, chunk_size=chunk_size))
    if afss and len({a.shape for a in afss}) != 1:
        raise ValueError("all AFS must have the same dimension")
    return (np.sum(afss, 0) if afss else None), np.concatenate(blocks, 0)
