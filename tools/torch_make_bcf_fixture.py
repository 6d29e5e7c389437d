#!/usr/bin/env python3
"""Write the BCF fixture through the port: the counterpart of tools/make_bcf_fixture.py.

    python tools/torch_make_bcf_fixture.py OUT.bcf

Writes tools/make_bcf_fixture.py's records (3,000 on chr1, 500 on chr2, two
samples, from numpy's default_rng(2026)) with phlash_tpu_torch.io.bcf's
write_bcf to OUT.bcf and its index OUT.bcf.csi.  The output path must be
given: tests/fixtures/sample.bcf is the JAX package's and stays as it is
(tests/test_torch_make_bcf_fixture.py holds this output to it byte for
byte).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from phlash_tpu_torch.io.bcf import write_bcf  # noqa: E402

HEADER = "\n".join(
    [
        "##fileformat=VCFv4.2",
        '##FILTER=<ID=PASS,Description="All filters passed">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        "##contig=<ID=chr1,length=1000000>",
        "##contig=<ID=chr2,length=500000>",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsampleA\tsampleB",
    ]
)


def make_records(chrom: str, n: int, span: int, rng: np.random.Generator):
    "n records at distinct sorted positions in [1, span), each sample's genotype drawn from rng."
    pos = np.sort(rng.choice(np.arange(1, span), size=n, replace=False))
    for p in pos:
        gts = []
        for _ in range(2):
            r = rng.random()
            if r < 0.05:
                gts.append((None, None))
            elif r < 0.45:
                gts.append((0, 1))
            elif r < 0.60:
                gts.append((1, 1))
            else:
                gts.append((0, 0))
        yield (chrom, int(p), "A", ["T"], gts)


def write(out: str) -> None:
    "The fixture's records to `out` and its .csi index."
    rng = np.random.default_rng(2026)
    records = list(make_records("chr1", 3000, 1_000_000, rng))
    records += list(make_records("chr2", 500, 500_000, rng))
    write_bcf(out, HEADER, records, index=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="the .bcf to write (its index goes beside it as .csi)")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write(args.out)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes) + .csi")


if __name__ == "__main__":
    main()
