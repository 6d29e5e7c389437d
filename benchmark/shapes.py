"""A cell's shapes, worked out from its inputs and fit's documented rules.

What the kernels of one SVGD iteration and one held-out ELPD run on: the
particles P, the minibatch S, the warm-up filter's L (the overlap) and the
likelihood's (chunk_size), the ELPD's chunks an evaluation, M and D of the
pattern, and the AFS term's n - 1 and transform rows.  The per-layer
readers count operations and bytes at these shapes, and the harness gives
fit the minibatch size its rule resolves at the traffic's niter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.reference import model


@dataclass(frozen=True)
class Shapes:
    P: int
    S: int
    N: int  # training chunks
    overlap: int
    chunk_size: int
    N_test: int  # held-out chunks
    S_elpd: int  # held-out chunks an evaluation
    M: int
    D: int
    nm1: int  # AFS entries (0 without an AFS)
    R: int  # AFS transform rows
    spc: int  # SVGD iterations a call


def chunk_count(het: np.ndarray, overlap: int, chunk_size: int) -> int:
    "Chunks of chunk_size + overlap windows that fit's chunker cuts from every row."
    rows, W = het.shape
    return rows * max(1, -(-W // (chunk_size + overlap)))


def resolve(ref: list, ref_test, options: dict, traffic: dict) -> Shapes:
    """The shapes of a cell whose training contigs are `ref` and held-out
    contig `ref_test` (benchmark/inputs.RefContig).  The minibatch size is
    the traffic's `minibatch_size`, or fit's rule at its `minibatch_rule_niter`
    (max(1, min(5, N / niter)), training.resolve_minibatch_size)."""
    window, overlap = options["window_size"], options["overlap"]
    chunk_size = options.get("chunk_size") or int(min(0.2 * c.length / window for c in ref))
    N = sum(chunk_count(c.het, overlap, chunk_size) for c in ref)
    S = traffic.get("minibatch_size") or max(1, min(5, int(N / traffic["minibatch_rule_niter"])))
    max_samples = options.get("max_samples", 20)
    N_test = chunk_count(ref_test.het[:max_samples], overlap, chunk_size)
    S_elpd = min(N_test, int(options.get("elpd_samples") or max(S, 4)))
    widths = model.pattern_widths(options.get("pattern", "14*1+1*2"))
    afss = [c.afs for c in ref if c.afs is not None]
    nm1 = R = 0
    if afss:
        afs = np.sum(afss, 0)
        nm1, R = len(afs), model.default_afs_transform(afs).shape[0]
    return Shapes(P=int(options.get("num_particles", 500)), S=int(S), N=N, overlap=overlap,
                  chunk_size=chunk_size, N_test=N_test, S_elpd=S_elpd, M=sum(widths),
                  D=len(widths) + 3, nm1=nm1, R=R, spc=int(options.get("steps_per_call", 10)))
