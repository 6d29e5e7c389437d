"""Frozen copy of tools/torch_genome_scale_demo.py's whole-genome VCF synthesis.

22 autosomes at CHROM_MB (GRCh38's lengths rounded to the Mb), one
single-diploid VCF each, Poisson het sites at ~1 per kb: 85% het (0/1),
12% hom-alt (1/1), 3% missing (./.), drawn from one numpy generator in
chromosome order.  The draws and the file text are the tool's, byte for
byte (benchmark/tests/test_frozen.py holds them to it); the copy splits
the draw (`draw_chromosome`) from the writing (`write_vcf`), so that the
benchmark's reference can window the same records without reading the
files back.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

CHROM_MB = [248, 242, 198, 190, 182, 171, 159, 145, 138, 134,
            135, 133, 114, 107, 102, 90, 83, 80, 59, 64, 47, 51]  # ~3.07 Gbp
SAMPLE = "NA00001"
GENOTYPES = np.array(["0/1", "1/1", "./."])
KIND_P = [0.85, 0.12, 0.03]


def draw_chromosome(length: int, rng: np.random.Generator,
                    het_per_bp: float = 1e-3) -> tuple[np.ndarray, np.ndarray]:
    "(positions, 1-based and sorted; kinds, indices into GENOTYPES) of one chromosome."
    n = rng.poisson(het_per_bp * length)
    pos = np.sort(rng.choice(length, size=n, replace=False)) + 1
    kind = rng.choice(3, size=n, p=KIND_P)
    return pos, kind


def write_vcf(path: str, chrom: str, length: int, pos: np.ndarray, kind: np.ndarray) -> None:
    "The chromosome's records as a gzipped single-sample VCF."
    gt = GENOTYPES[kind]
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom},length={length}>\n")
        f.write(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{SAMPLE}\n")
        rows = "\n".join(
            f"{chrom}\t{p}\t.\tA\tT\t.\tPASS\t.\tGT\t{g}" for p, g in zip(pos, gt)
        )
        f.write(rows + "\n")


def synthesize(tdir: str, scale: float, seed: int, chrom_mb=CHROM_MB, het_per_bp: float = 1e-3):
    """The chromosomes' VCFs in tdir, one generator drawn in turn:
    [(path, name, length, positions, kinds)]."""
    rng = np.random.default_rng(seed)
    out = []
    for i, mb in enumerate(chrom_mb, 1):
        length = int(mb * 1e6 * scale)
        path = os.path.join(tdir, f"chr{i}.vcf.gz")
        pos, kind = draw_chromosome(length, rng, het_per_bp)
        write_vcf(path, f"chr{i}", length, pos, kind)
        out.append((path, f"chr{i}", length, pos, kind))
    return out
