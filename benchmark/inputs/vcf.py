"""Input kind "vcf": one single-diploid gzipped VCF per autosome, read by the fit.

The frozen copy of the whole-genome synthesis (benchmark/frozen/genome.py)
writes the VCFs from the seed into a temporary directory under TMPDIR; the
fit reads each through phlash_tpu_torch.contig, and the reference reads the
drawn records, windowed here.
"""

from __future__ import annotations

import tempfile
import time

from benchmark.frozen import genome
from benchmark.inputs import Inputs, window_records


def make(data: dict, seed: int, window: int, seconds: dict) -> Inputs:
    import phlash_tpu_torch

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="phlash_bench_")
    scale = data.get("scale", 1.0)
    recs = genome.synthesize(tmp.name, scale, seed, chrom_mb=data["chrom_mb"],
                             het_per_bp=data["het_per_bp"])
    seconds["write_vcfs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    contigs = [phlash_tpu_torch.contig(path, samples=[genome.SAMPLE], region=f"{name}:1-{L}")
               for path, name, L, _, _ in recs]
    ref = [window_records(pos, kind, L, window) for _, _, L, pos, kind in recs]
    seconds["window_records"] = time.perf_counter() - t0
    return Inputs(train=contigs[:-1], test=contigs[-1], ref=ref[:-1], ref_test=ref[-1],
                  seconds=seconds, _tmp=tmp)
