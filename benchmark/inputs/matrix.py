"""Input kind "matrix": one in-memory RawContig per autosome, drawn from the seed.

Each (samples, windows) int8 matrix marks a window het with probability
het_window_p and missing with missing_window_p, independently; the AFS
(2 * samples - 1 entries) is Poisson with a neutral spectrum's mean
afs_theta_per_bp x length / k.  The reference reads the same arrays.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.inputs import Inputs, RefContig, chromosome_lengths


def make(data: dict, seed: int, window: int, seconds: dict) -> Inputs:
    from phlash_tpu_torch.data import RawContig

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    R = int(data["samples"])
    ks = np.arange(1, 2 * R)
    contigs, ref = [], []
    for length in chromosome_lengths(data):
        W = length // window
        het = np.zeros((R, W), dtype=np.int8)
        flat = het.reshape(-1)
        flat[rng.integers(0, R * W, rng.poisson(data["het_window_p"] * R * W))] = 1
        flat[rng.integers(0, R * W, rng.poisson(data["missing_window_p"] * R * W))] = -1
        # a neutral spectrum's expectation theta L / k, drawn per entry
        afs = rng.poisson(data["afs_theta_per_bp"] * W * window / ks).astype(np.int64)
        contigs.append(RawContig(het_matrix=het, afs=afs, window_size=window))
        ref.append(RefContig(het=het, afs=afs, length=W * window))
    seconds["draw_matrices"] = time.perf_counter() - t0
    return Inputs(train=contigs[:-1], test=contigs[-1], ref=ref[:-1], ref_test=ref[-1],
                  seconds=seconds)
