"""Input kind "bcf": the walkthrough's contig as an indexed BCF, read by the fit in two regions.

The frozen copy of docs/torch_example.py's data (benchmark/frozen/
walkthrough.py) draws one diploid contig of `windows` windows (times the
data's `scale`, if any) from the seed and writes it as an indexed BCF
into a temporary directory under TMPDIR.  The fit reads the contig's
first four fifths through phlash_tpu_torch.contig(path, samples=[sample],
region=...) and holds out the rest, as the walkthrough's `load` does; the
reference windows the drawn records of each region, not the file.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from benchmark.frozen import walkthrough
from benchmark.inputs import Inputs, window_records


def regions(span: int) -> list[tuple[int, int]]:
    "The walkthrough's (training, held-out) 1-based regions of a contig of `span` bp."
    cut = span * 4 // 5
    return [(1, cut), (cut + 1, span)]


def make(data: dict, seed: int, window: int, seconds: dict) -> Inputs:
    import phlash_tpu_torch

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="phlash_bench_")
    path = os.path.join(tmp.name, "walkthrough.bcf")
    het = walkthrough.simulate(int(data["windows"] * data.get("scale", 1.0)), seed)
    span = walkthrough.write_bcf(path, het, window)
    seconds["write_bcf"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pos = walkthrough.positions(het, window)
    contigs, ref = [], []
    for a, b in regions(span):
        contigs.append(phlash_tpu_torch.contig(path, samples=[walkthrough.SAMPLE],
                                               region=f"{walkthrough.CONTIG}:{a}-{b}"))
        mine = pos[(pos >= a) & (pos <= b)] - (a - 1)  # positions within the region
        ref.append(window_records(mine, np.zeros(len(mine), dtype=np.int64), b - a + 1, window))
    seconds["window_records"] = time.perf_counter() - t0
    return Inputs(train=contigs[:1], test=contigs[1], ref=ref[:1], ref_test=ref[1],
                  seconds=seconds, _tmp=tmp)
