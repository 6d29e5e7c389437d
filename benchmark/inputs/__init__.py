"""A cell's inputs, made from --seed: the genome the fit reads, and the same data for the reference.

A configuration's "data" block says what to make; its "input" names the
kind, a module benchmark/inputs/<kind>.py with
`make(data, seed, window, seconds) -> Inputs`, found by name, so a later
kind is a new file:
- vcf: one single-diploid gzipped VCF per autosome, written by the frozen
  copy of the whole-genome synthesis into a temporary directory (under
  TMPDIR), and read by the fit through phlash_tpu_torch.contig;
- matrix: one in-memory RawContig per autosome, a (samples, windows) int8
  matrix of het (1), hom (0) and missing (-1) windows and an AFS of
  2 * samples - 1 entries, all drawn from the seed.
The held-out autosome (the last of chrom_mb) becomes the fit's test_data.

Beside the contigs the fit reads, `Inputs.ref` holds what the reference
reads: each contig's windowed het matrix, its AFS and its length as the
program's contig reports it, worked out from the drawn records without
the program's readers.
"""

from __future__ import annotations

import importlib
import tempfile
from dataclasses import dataclass, field

import numpy as np


@dataclass
class RefContig:
    het: np.ndarray  # (rows, windows) int8 in {-1, 0, 1}
    afs: np.ndarray | None  # (n - 1,)
    length: int  # the contig's length in bp, as the program's Contig.L gives it


@dataclass
class Inputs:
    train: list  # the fit's contigs
    test: object  # the held-out contig
    ref: list[RefContig]  # the training contigs for the reference, in the same order
    ref_test: RefContig
    seconds: dict = field(default_factory=dict)  # time of each step of making them
    _tmp: tempfile.TemporaryDirectory | None = None

    def close(self) -> None:
        "Delete the files written."
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None


def chromosome_lengths(data: dict) -> list[int]:
    return [int(mb * 1e6 * data.get("scale", 1.0)) for mb in data["chrom_mb"]]


def window_records(pos: np.ndarray, kind: np.ndarray, length: int, window: int) -> RefContig:
    """One diploid's windows as a VCF reader defines them over region
    1..length: a window is het when any record in it is 0/1; the AFS counts
    the 0/1 records (derived-allele count 1 of 2)."""
    W = length // window
    het = np.zeros((1, W), dtype=np.int8)
    is_het = kind == 0
    het[0, np.minimum((pos[is_het] - 1) // window, W - 1)] = 1
    return RefContig(het=het, afs=np.array([int(is_het.sum())]), length=length - 1)


def make(config: dict, seed: int) -> Inputs:
    "The inputs of a configuration at --seed, by its input kind's module."
    data = config["data"]
    kind = importlib.import_module(f"benchmark.inputs.{data['input']}")
    return kind.make(data, seed, config["fit"]["window_size"], {})
