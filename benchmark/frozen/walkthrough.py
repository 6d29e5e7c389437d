"""Frozen copy of docs/torch_example.py's data: the walkthrough's draw and its indexed BCF.

`simulate_to_bcf(path, L_windows, seed)` there draws one diploid contig of
L windows of 100 bp from the continuous SMC' process under
phlash_tpu_torch.sim.bottleneck_demography(theta=1e-2)
(sim.simulate_smc_continuous: numpy's default_rng(seed), drawn in the same
calls and order), and writes every window that holds a het site as one
0/1 record at the window's midpoint into a BCF2.2 file with its .csi index
(phlash_tpu_torch.io.bcf.write_bcf).  This copy gives the same het row and
the same bytes (benchmark/tests/test_bench_walkthrough.py holds them to
the walkthrough's), so that a change of the program moves neither the
cell's data nor its set-up.  It splits the draw (`simulate`) from the
writing (`write_bcf`), and its writer knows only the walkthrough's header
and records.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

CONTIG = "chr1"
SAMPLE = "sample1"
THETA = 1e-2  # the demography's scaled mutation and recombination rates a window
M = 16  # the demography's epochs


def demography() -> tuple[np.ndarray, np.ndarray]:
    """bottleneck_demography(theta=1e-2)'s size history: (the time grid, 0
    then geomspace(1e-3, 15, M - 1); the coalescence rates, 10 in epochs
    M // 3 to M // 2 and 1 elsewhere)."""
    t = np.concatenate([[0.0], np.geomspace(1e-3, 15.0, M - 1)])
    c = np.ones(M)
    c[M // 3: M // 2] = 10.0
    return t, c


def _inv_hazard(t_grid: np.ndarray, c: np.ndarray, t0: float, E: float, mult: float = 1.0,
                cap: float = np.inf) -> float:
    "The h with the integral of mult * c from t0 to h equal to E; `cap` where it lies past cap."
    k = int(np.searchsorted(t_grid, t0, side="right") - 1)
    h = t0
    while h < cap:
        end = min(t_grid[k + 1] if k + 1 < len(t_grid) else np.inf, cap)
        rate = mult * c[k]
        step = (end - h) * rate
        if E <= step or not np.isfinite(end):
            return min(h + E / rate, cap)
        E -= step
        h = end
        if h < cap:
            k += 1
    return cap


def _segments(L: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    "The TMRCA path over [0, L] windows: (segment starts and L, the TMRCA of each segment)."
    t_grid, c = demography()
    rho = THETA
    s = _inv_hazard(t_grid, c, 0.0, rng.standard_exponential())
    x = 0.0
    starts, tmrca = [0.0], [s]
    while True:
        x += rng.standard_exponential() / (2.0 * rho * s)
        if x >= L:
            break
        u = rng.uniform(0.0, s)
        h = _inv_hazard(t_grid, c, u, rng.standard_exponential(), mult=2.0, cap=s)
        if h < s:
            if rng.random() < 0.5:
                s = h
            else:
                continue
        else:
            s = _inv_hazard(t_grid, c, s, rng.standard_exponential())
        starts.append(x)
        tmrca.append(s)
    starts.append(float(L))
    return np.asarray(starts), np.asarray(tmrca)


def simulate(L: int, seed: int) -> np.ndarray:
    "The contig's (L,) int8 het row: 1 where a window holds a het site, else 0."
    rng = np.random.default_rng(seed)
    starts, tmrca = _segments(L, rng)
    lengths = np.diff(starts)
    n_mut = rng.poisson(THETA * tmrca * lengths)
    total = int(n_mut.sum())
    obs = np.zeros(L, dtype=np.int8)
    if total:
        seg_of = np.repeat(np.arange(len(lengths)), n_mut)
        pos = starts[seg_of] + rng.random(total) * lengths[seg_of]
        obs[np.minimum(pos.astype(np.int64), L - 1)] = 1
    return obs


def positions(het: np.ndarray, window: int) -> np.ndarray:
    "The records' 1-based positions: the midpoint of every het window."
    return np.flatnonzero(het == 1) * window + window // 2


# -- the BCF2.2 writer, for this header and these records ----------------------

_MAGIC = b"BCF\x02\x02"
_BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_BLOCK = 0xFF00
_GT_KEY = 1  # the header's string dictionary: PASS 0, GT 1
# after the position: rlen 1, qual 0, 2 alleles and 0 INFO, 1 FORMAT and 1
# sample; ID "", REF "A", ALT "T", FILTER [PASS]; then GT as one int8 pair, 0/1
_SHARED_TAIL = (struct.pack("<if", 1, 0.0) + struct.pack("<II", 2 << 16, (1 << 24) | 1)
                + b"\x07" + b"\x17A" + b"\x17T" + b"\x11\x00")
_INDIV = b"\x11" + bytes([_GT_KEY]) + bytes([(2 << 4) | 1]) + bytes([2, 4])


def header(span: int) -> str:
    return "\n".join([
        "##fileformat=VCFv4.2",
        '##FILTER=<ID=PASS,Description="All filters passed">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        f"##contig=<ID={CONTIG},length={span}>",
        f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{SAMPLE}",
    ])


def _bgzf_block(payload: bytes) -> bytes:
    "One BGZF block: a gzip member with the BC extra field."
    raw = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = raw.compress(payload) + raw.flush()
    head = struct.pack("<4BIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, ord("B"), ord("C"), 2,
                       len(cdata) + 25)
    return head + cdata + struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF)


def _reg2bin(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> int:
    "The smallest CSI bin holding the 0-based half-open [beg, end)."
    end -= 1
    level, shift = depth, min_shift
    t = ((1 << (3 * depth)) - 1) // 7
    while level > 0:
        if beg >> shift == end >> shift:
            return t + (beg >> shift)
        level -= 1
        shift += 3
        t -= 1 << (3 * level)
    return 0


def _write_csi(path: str, records: list, min_shift: int = 14, depth: int = 5) -> None:
    "A CSI v1 index of one contig's (beg0, end0, voffset start, voffset end) records."
    bins: dict[int, list] = {}
    for beg0, end0, vs, ve in records:
        bins.setdefault(_reg2bin(beg0, end0, min_shift, depth), []).append((vs, ve))
    out = bytearray(b"CSI\x01" + struct.pack("<iii", min_shift, depth, 0) + struct.pack("<i", 1))
    out += struct.pack("<i", len(bins))
    for b in sorted(bins):
        merged = [list(bins[b][0])]
        for cb, ce in bins[b][1:]:
            if cb <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], ce)
            else:
                merged.append([cb, ce])
        out += struct.pack("<IQi", b, min(m[0] for m in merged), len(merged))
        for cb, ce in merged:
            out += struct.pack("<QQ", cb, ce)
    with open(path, "wb") as fh:
        for at in range(0, len(out), _BLOCK):
            fh.write(_bgzf_block(bytes(out[at: at + _BLOCK])))
        fh.write(_BGZF_EOF)


def write_bcf(path: str, het: np.ndarray, window: int) -> int:
    """The het row as the walkthrough's BCF at `path` and its index at
    path + ".csi"; returns the contig's span in bp."""
    span = len(het) * window
    hdr = header(span).encode() + b"\x00"
    buf = bytearray(_MAGIC + struct.pack("<I", len(hdr)) + hdr)
    coffset, index = 0, []
    with open(path, "wb") as fh:
        for pos in positions(het, window):
            shared = struct.pack("<ii", 0, int(pos) - 1) + _SHARED_TAIL
            vs = (coffset << 16) | len(buf)
            buf += struct.pack("<II", len(shared), len(_INDIV)) + shared + _INDIV
            while len(buf) >= _BLOCK:
                block = _bgzf_block(bytes(buf[:_BLOCK]))
                fh.write(block)
                coffset += len(block)
                del buf[:_BLOCK]
            index.append((int(pos) - 1, int(pos), vs, (coffset << 16) | len(buf)))
        if buf:
            fh.write(_bgzf_block(bytes(buf)))
        fh.write(_BGZF_EOF)
    _write_csi(path + ".csi", index)
    return span
