"""Native tabix (.tbi) index support for bgzipped text VCFs (no pysam).

A copy of phlash_tpu/io/tabix.py (importing it would load JAX).

A .tbi is the fixed-binning (min_shift=14, depth=5) ancestor of CSI: per
reference sequence it stores bin -> chunks of BGZF virtual offsets plus a
16 kb linear index.  We use it to start the streaming text-VCF scan at the
first chunk overlapping a region instead of at the beginning of the file —
together with the existing early-stop this makes whole-genome .vcf.gz
region queries O(region).

The writer exists for fixtures/round-trip tests (bgzip + index a text VCF
without bcftools/tabix): see write_tabixed_vcf.
"""

from __future__ import annotations

import gzip
import struct

from phlash_tpu_torch.io.bcf import (
    _BGZF_EOF,
    _BgzfWriter,
    _reg2bin,
    _reg2bins,
    _bgzf_block,
)

_MIN_SHIFT, _DEPTH = 14, 5


def read_tbi(path: str):
    """Parse a .tbi index.

    Returns (names, refs) with names the reference-sequence order and
    refs[i] a dict bin -> [(chunk_beg, chunk_end), ...] of virtual offsets.
    """
    payload = gzip.decompress(open(path, "rb").read())
    if payload[:4] != b"TBI\x01":
        raise ValueError(f"{path}: not a TBI v1 index")
    n_ref = struct.unpack_from("<i", payload, 4)[0]
    # format, col_seq, col_beg, col_end, meta, skip are fixed for VCF
    (l_nm,) = struct.unpack_from("<i", payload, 32)
    at = 36
    names = payload[at : at + l_nm].rstrip(b"\x00").decode().split("\x00")
    at += l_nm
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", payload, at)
        at += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", payload, at)
            at += 8
            chunks = []
            for _ in range(n_chunk):
                cb, ce = struct.unpack_from("<QQ", payload, at)
                at += 16
                chunks.append((cb, ce))
            bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", payload, at)
        at += 4 + 8 * n_intv  # linear index: unused (bins suffice here)
        refs.append(bins)
    return names, refs


def region_start_voff(path: str, contig: str, start: int, end: int) -> int | None:
    """Earliest virtual offset whose chunk overlaps contig:start-end (1-based
    inclusive), or None when the index has no records there / no such contig."""
    names, refs = read_tbi(path)
    if contig not in names:
        return None
    bins = refs[names.index(contig)]
    starts = [
        cb
        for b in _reg2bins(start - 1, end, _MIN_SHIFT, _DEPTH)
        if b in bins
        for cb, _ce in bins[b]
    ]
    return min(starts) if starts else None


def write_tbi(path: str, names: list[str], records) -> None:
    """Write a .tbi for a bgzipped VCF.  `records` is an iterable of
    (ref_id, beg0, end0, voff_start, voff_end) in file order."""
    per_ref: list[dict[int, list[tuple[int, int]]]] = [dict() for _ in names]
    intv: list[dict[int, int]] = [dict() for _ in names]
    for rid, beg0, end0, vs, ve in records:
        b = _reg2bin(beg0, end0, _MIN_SHIFT, _DEPTH)
        per_ref[rid].setdefault(b, []).append((vs, ve))
        k = beg0 >> _MIN_SHIFT
        intv[rid].setdefault(k, vs)
    nm = b"\x00".join(n.encode() for n in names) + b"\x00"
    out = bytearray()
    out += b"TBI\x01" + struct.pack("<i", len(names))
    # format=2 (VCF), seq/beg/end columns 1/2/0, meta '#', skip 0
    out += struct.pack("<6i", 2, 1, 2, 0, ord("#"), 0)
    out += struct.pack("<i", len(nm)) + nm
    for bins, iv in zip(per_ref, intv):
        out += struct.pack("<i", len(bins))
        for b in sorted(bins):
            chunks = bins[b]
            merged = [list(chunks[0])]
            for cb, ce in chunks[1:]:
                if cb <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], ce)
                else:
                    merged.append([cb, ce])
            out += struct.pack("<Ii", b, len(merged))
            for cb, ce in merged:
                out += struct.pack("<QQ", cb, ce)
        n_intv = max(iv) + 1 if iv else 0
        out += struct.pack("<i", n_intv)
        last = 0
        for k in range(n_intv):
            last = iv.get(k, last)
            out += struct.pack("<Q", last)
    with open(path, "wb") as fh:
        view = memoryview(bytes(out))
        for at in range(0, len(view), 0xFF00):
            fh.write(_bgzf_block(bytes(view[at : at + 0xFF00])))
        fh.write(_BGZF_EOF)


def write_tabixed_vcf(path: str, text: str) -> None:
    """BGZF-compress VCF text to `path` (must end .vcf.gz) and write a
    matching .tbi — a dependency-free stand-in for bgzip+tabix."""
    names: list[str] = []
    ridx = []
    with open(path, "wb") as fh:
        w = _BgzfWriter(fh)
        for line in text.splitlines(keepends=True):
            if not line.startswith("#"):
                fields = line.split("\t", 2)
                chrom, pos = fields[0], int(fields[1])
                if chrom not in names:
                    names.append(chrom)
                vs = w.tell_virtual()
                w.write(line.encode())
                ridx.append((names.index(chrom), pos - 1, pos, vs, w.tell_virtual()))
            else:
                w.write(line.encode())
        w.finish()
    write_tbi(path + ".tbi", names, ridx)
