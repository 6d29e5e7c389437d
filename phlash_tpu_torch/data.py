"""Data ingestion: genome files -> int8 chunk tensors + an aggregate AFS.

Port of phlash_tpu/data.py (importing it would load JAX): the chunker, the
`Contig` types (`RawContig`, with `.psmcfa` parsing; `TreeSequenceContig`,
tskit imported only inside; `VcfContig` over .vcf, .vcf.gz and .bcf, with
the streaming C-tokenizer path, the tabix seek, the sortedness rescan and
the native BCF path), the `contig()` factory, `subsample_chrom` and
`init_mcmc_data` with its spawn-context worker pool.  Values are {-1
missing, 0 hom, 1 het}.  pysam, tskit and tszip are optional: pysam, when
installed, is preferred for its indexed region fetch.  The one difference:
`RawContig.get_data` returns only the het matrix and the AFS.
"""

from __future__ import annotations

import gzip
import logging
import os
import re
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Iterable, NamedTuple

import numpy as np

from phlash_tpu_torch.mp import CpuProcessPoolExecutor

logger = logging.getLogger(__name__)


class ChunkedContig(NamedTuple):
    chunks: np.ndarray | None  # int8 (num_chunks, overlap + chunk_size)
    afs: np.ndarray | None  # int64 (n - 1,)


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


def _mask_to_bool(mask: list[tuple[int, int]] | None, L: int, window: int) -> np.ndarray:
    "Boolean vector over windows: True where the window overlaps any mask interval."
    cols = np.zeros(-(-L // window), dtype=bool)
    for a, b in mask or []:
        lo = max(0, int(a) // window)
        hi = min(len(cols), -(-int(b) // window))
        cols[lo:hi] = True
    return cols


# ---------------------------------------------------------------------------
# contig types
# ---------------------------------------------------------------------------


class Contig(ABC):
    @abstractmethod
    def get_data(self, window_size: int) -> dict[str, np.ndarray]:
        """Return {'het_matrix': int8 (N, L/w) or None, 'afs': int64 (n-1,) or None}."""

    @property
    @abstractmethod
    def N(self):
        "Number of ploids."

    @property
    @abstractmethod
    def L(self):
        "Sequence length in base pairs."

    @property
    def size(self):
        if self.L is None or self.N is None:
            return None
        return self.L * self.N

    def to_raw(self, window_size: int) -> "RawContig":
        "Materialize (useful for pickling after slow parsing)."
        return RawContig(**self.get_data(window_size), window_size=window_size)

    def to_chunked(self, overlap: int, chunk_size: int, window_size: int = 100) -> ChunkedContig:
        d = self.get_data(window_size)
        ch = None
        if d["het_matrix"] is not None:
            ch = chunk_het_matrix(d["het_matrix"], overlap=overlap, chunk_size=chunk_size)
        return ChunkedContig(chunks=ch, afs=d["afs"])


@dataclass(frozen=True)
class RawContig(Contig):
    "A contig whose het matrix and AFS are already computed (either may be None)."

    het_matrix: np.ndarray | None  # int8 (rows, windows)
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
    def N(self):
        # one row per diploid pair => two ploids per row
        return None if self.het_matrix is None else 2 * self.het_matrix.shape[0]

    @property
    def L(self):
        if self.het_matrix is None:
            return None
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


@dataclass(frozen=True)
class TreeSequenceContig(Contig):
    """Data from a tskit tree sequence (optional dependency).

    Args:
        ts: tskit.TreeSequence
        nodes: list of (node1, node2) pairs, one diploid each; default all
            individuals.
        mask: list of (a, b) intervals to exclude.
    """

    ts: object
    nodes: list[tuple[int, int]] = None
    mask: list[tuple[int, int]] = None

    def __post_init__(self):
        try:
            assert isinstance(self._nodes, list)
            for pair in self._nodes:
                assert isinstance(pair, tuple) and len(pair) == 2
                for n in pair:
                    int(n)
        except (AssertionError, TypeError, ValueError):
            raise ValueError(
                "nodes must be a list of (node1, node2) leaf-id tuples, one "
                "tuple per analyzed diploid"
            )

    @property
    def _nodes(self):
        if self.nodes is not None:
            return self.nodes
        return [tuple(i.nodes) for i in self.ts.individuals()]

    @property
    def N(self):
        return 2 * len(self._nodes)

    @property
    def L(self):
        return int(self.ts.get_sequence_length())

    def get_data(self, window_size: int):
        mask = self.mask or []
        # complement of the mask as sorted disjoint breakpoints
        bp, keep = _mask_breakpoints(mask, self.L)
        nodes_flat = sorted({x for pair in self._nodes for x in pair})
        afs = self.ts.allele_frequency_spectrum(
            sample_sets=[nodes_flat], windows=bp, polarised=True, span_normalise=False
        )[keep].sum(0)[1:-1]
        het_matrix = _read_ts(self.ts, self._nodes, window_size)
        het_matrix[:, _mask_to_bool(mask, self.L, window_size)] = -1
        return dict(afs=afs, het_matrix=het_matrix)


def _mask_breakpoints(mask: list[tuple[int, int]], L: int):
    """Return (breakpoints, keep) where breakpoints tile [0, L] and keep[i]
    marks intervals NOT covered by the mask."""
    events = sorted({0, L} | {int(x) for a, b in mask for x in (a, b) if 0 <= x <= L})
    bp = np.array(events, dtype=float)
    mids = (bp[:-1] + bp[1:]) / 2
    covered = np.zeros(len(mids), dtype=bool)
    for a, b in mask:
        covered |= (mids >= a) & (mids < b)
    return bp, ~covered


def _read_ts(ts, nodes, window_size: int, progress: bool = False) -> np.ndarray:
    """Windowed heterozygote counts for each diploid pair from a tree sequence.

    The genotype vector each tskit variant yields is ordered by our sample
    list, so the two haplotypes of pair i sit at precomputed columns
    (lhs[i], rhs[i]); a variant contributes g[lhs] != g[rhs] to its window.
    """
    order = sorted({n for pair in nodes for n in pair})
    at = {n: i for i, n in enumerate(order)}
    lhs = np.array([at[a] for a, _ in nodes])
    rhs = np.array([at[b] for _, b in nodes])
    n_windows = -(-int(ts.get_sequence_length()) // window_size)
    out = np.zeros([len(nodes), n_windows], dtype=np.int8)
    variants = ts.variants(samples=order, copy=False)
    if progress:
        import tqdm.auto as tqdm

        variants = tqdm.tqdm(variants, total=ts.num_sites, desc="Reading tree sequence")
    for v in variants:
        g = v.genotypes
        out[:, int(v.position) // window_size] += g[lhs] != g[rhs]
    return out


# ---------------------------------------------------------------------------
# VCF
# ---------------------------------------------------------------------------

_GT_RE = re.compile(r"([0-9.]+)[/|]([0-9.]+)")


def _iter_vcf_text(path: str, contig: str, start: int, end: int, samples: list[str]):
    """Minimal VCF text parser ('.vcf' / '.vcf.gz'), yielding per-record
    dicts {'pos', 'het' int8 (S,), 'nd' int}.  Used when pysam is absent."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        cols = None
        for line in fh:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                header = line.rstrip("\n").split("\t")
                all_samples = header[9:]
                missing = set(samples) - set(all_samples)
                if missing:
                    raise ValueError(f"samples not found in the vcf: {missing}")
                cols = [9 + all_samples.index(s) for s in samples]
                continue
            if cols is None:
                continue
            fields = line.rstrip("\n").split("\t")
            if fields[0] != contig:
                continue
            pos = int(fields[1])
            if pos < start or pos > end:
                continue
            fmt = fields[8].split(":")
            try:
                gt_i = fmt.index("GT")
            except ValueError:
                continue
            het = np.zeros(len(samples), dtype=np.int8)
            nd = 0
            for i, ci in enumerate(cols):
                m = _GT_RE.match(fields[ci].split(":")[gt_i])
                if not m or "." in m.groups():
                    het[i] = -1
                    continue
                a, b = (int(g) for g in m.groups())
                het[i] = a != b
                nd += (a != 0) + (b != 0)
            yield dict(pos=pos, het=het, nd=nd)


def _iter_vcf_pysam(path: str, contig: str, start: int, end: int, samples: list[str]):
    """Region-indexed record iteration through pysam (.bcf / tabixed .vcf.gz).

    Yields the same {'pos', 'het', 'nd'} records as the text parser: a call
    is het when its two alleles differ, missing (-1) when either allele is
    absent, and every non-reference allele counts toward nd.

    `start`/`end` are 1-based inclusive (the convention shared by
    _iter_vcf_text and io.bcf.iter_bcf); pysam's fetch() takes 0-based
    half-open coordinates, so the window is shifted by one here — passing
    `start` through unshifted would silently drop a record sitting exactly
    on the left edge of the region.
    """
    import pysam

    with pysam.VariantFile(path) as vf:
        vf.subset_samples(samples)
        for rec in vf.fetch(contig=contig, start=start - 1, stop=end):
            # fetch() returns records *overlapping* the window, so a
            # multi-base record (deletion) starting before the region edge
            # can appear; filter on the start position like the text and
            # native-BCF backends do (a pos > end record cannot overlap)
            if rec.pos < start:
                continue
            calls = [tuple(rec.samples[s]["GT"] or ()) for s in samples]
            het = np.array(
                [
                    -1 if (len(gt) != 2 or None in gt) else int(gt[0] != gt[1])
                    for gt in calls
                ],
                dtype=np.int8,
            )
            nd = sum(1 for gt in calls for g in gt if g not in (None, 0))
            yield dict(pos=rec.pos, het=het, nd=nd)


class _FastPathUnavailable(Exception):
    "Raised when the streaming C fast path vanishes mid-scan (fall back)."


class PloidyError(ValueError):
    "A record's derived-allele count exceeds 2*num_samples (non-diploid GT)."


def _accumulate_windows(H, afs, pos, het, nd, start: int, window_size: int):
    """Fold one batch of records into the windowed het matrix + AFS, in place.

    H is (S, W) bool, afs is (2S+1,) int64; het is (R, S) per-sample het
    counts in output sample order, nd is (R,) derived-allele counts.
    Shared by the text-VCF and native-BCF vectorized paths so their
    windowing semantics cannot drift apart.
    """
    S, W = H.shape
    if nd.size and int(nd.max()) >= afs.size:
        raise PloidyError(
            f"derived-allele count {int(nd.max())} exceeds 2*num_samples="
            f"{afs.size - 1}; only diploid calls are supported"
        )
    win = np.minimum((pos - start) // window_size, W - 1).astype(np.int64)
    hot = het.T > 0  # (S, R)
    rows = np.broadcast_to(np.arange(S)[:, None], hot.shape)
    np.logical_or.at(H, (rows, np.broadcast_to(win[None], hot.shape)), hot)
    afs += np.bincount(nd, minlength=afs.size)


@dataclass(frozen=True)
class VcfContig(Contig):
    """Data from a VCF/BCF file restricted to one region.

    The streaming reader early-stops once the region has been passed only
    when a tabix index supplied the seek offset (a .tbi proves the file is
    coordinate-sorted — tabix refuses to index unsorted input); files
    without an index are always scanned in full, which is correct for any
    record order.  If an indexed file still shows out-of-order positions
    (index/data mismatch) it is rescanned in full, with a warning.

    Args:
        vcf_file: path to a .vcf, .vcf.gz or .bcf file
        samples: sample ids to include
        contig: contig (chromosome) name
        interval: (start, end) positions
    """

    vcf_file: str
    samples: list[str]
    contig: str
    interval: tuple[int, int]
    mask: list[tuple[int, int]] = None
    _allow_empty_region: bool = field(repr=False, default=False)

    def __post_init__(self):
        if self.mask is not None:
            raise NotImplementedError(
                "masking is not implemented for VCFs; pre-filter with "
                "vcftools/bcftools instead"
            )
        if not self._allow_empty_region:
            if not self.contig:
                raise ValueError("a contig name must be given for VCF input")
            if self.interval[0] >= self.interval[1]:
                raise ValueError("interval must satisfy start < end")
        if not self.samples:
            raise ValueError("no samples were provided")
        if not all(isinstance(s, str) for s in self.samples):
            raise ValueError("samples must be a list of string ids")

    @property
    def N(self):
        return 2 * len(self.samples)

    @property
    def L(self):
        return self.interval[1] - self.interval[0]

    def _records(self, start, end):
        args = (self.vcf_file, self.contig, start, end, self.samples)
        try:
            import pysam  # noqa: F401  (prefer pysam when present: indexed fetch)

            return _iter_vcf_pysam(*args)
        except ImportError:
            pass
        if self.vcf_file.endswith(".bcf"):
            from phlash_tpu_torch.io.bcf import iter_bcf  # native BCF2.2 reader

            return iter_bcf(*args)
        return _iter_vcf_text(*args)

    # streaming block size: large enough to amortize the C-tokenizer call,
    # small enough that memory stays O(block) for whole-genome inputs
    _STREAM_BLOCK = 16 << 20

    def _iter_line_blocks(self, start_voff: int = None) -> Iterable[bytes]:
        """Yield the file as blocks of complete lines (~_STREAM_BLOCK bytes).

        Works for plain and gzip text (gzip decompresses incrementally —
        BGZF files are valid multi-member gzip streams, so tabix-compressed
        .vcf.gz inputs stream too).  This replaces the whole-file read: a
        3 Gb-genome VCF never has more than one block resident.

        For a bgzipped file, `start_voff` (a BGZF virtual offset from a
        .tbi index) starts decompression at that block and skips into it,
        so a region query reads only the region's blocks.
        """
        if self.vcf_file.endswith(".gz"):
            raw = open(self.vcf_file, "rb")
            if start_voff is not None:
                raw.seek(start_voff >> 16)
            fh = gzip.GzipFile(fileobj=raw)
            if start_voff is not None:
                fh.read(start_voff & 0xFFFF)
        else:
            fh = open(self.vcf_file, "rb")
        tail = b""
        with fh:
            while True:
                block = fh.read(self._STREAM_BLOCK)
                if not block:
                    break
                block = tail + block
                cut = block.rfind(b"\n")
                if cut < 0:
                    tail = block
                    continue
                tail, block = block[cut + 1:], block[: cut + 1]
                yield block
        if tail:
            yield tail

    def _header_samples(self) -> list[str]:
        "Sample columns from the #CHROM header line (reads the file head)."
        for block in self._iter_line_blocks():
            hdr_at = block.find(b"#CHROM")
            if hdr_at < 0:
                if not block.lstrip().startswith(b"#"):
                    break  # records began without a header
                continue
            hdr = block[hdr_at: block.index(b"\n", hdr_at)].decode().split("\t")
            return hdr[9:]
        raise ValueError("malformed VCF: no #CHROM header line")

    def _get_data_fast(self, window_size: int) -> dict[str, np.ndarray] | None:
        """Streaming vectorized path: C tokenizer over ~16 MB blocks of
        complete lines + incremental numpy windowing.  Memory is O(block +
        windows), independent of file size; for tabix-indexed region
        queries the scan seeks to the region and stops as soon as it has
        been passed.

        .bcf files take the native batched reader (io.bcf.read_bcf_region)
        — its vectorized decode (~200 krec/s) beats a per-record Python
        loop over pysam even though htslib's C decoder is faster per
        record.  If the native reader rejects the file (exotic layout),
        the per-record path — pysam-backed when installed — takes over.
        """
        if self.vcf_file.endswith(".bcf"):
            try:
                return self._get_data_fast_bcf(window_size)
            except PloidyError:
                raise  # a data error, not a reader limitation: no fallback
            except Exception:
                logger.warning(
                    "%s: native BCF reader failed; falling back to the "
                    "per-record path",
                    self.vcf_file,
                    exc_info=True,
                )
                return None
        try:
            from phlash_tpu_torch.io import parse_vcf_lines, vcf_parser_backend
        except Exception:  # pragma: no cover - optional component
            return None
        if vcf_parser_backend() != "c":
            return None

        start, end = self.interval
        S = len(self.samples)
        W = (end - start + 1) // window_size
        H = np.zeros([S, W], dtype=bool)
        afs = np.zeros(2 * S + 1, dtype=np.int64)

        all_samples = self._header_samples()
        missing = set(self.samples) - set(all_samples)
        if missing:
            raise ValueError(f"samples not found in the vcf: {missing}")
        cols = sorted(9 + all_samples.index(s) for s in self.samples)
        order = np.argsort(
            np.argsort([9 + all_samples.index(s) for s in self.samples])
        )

        # a .tbi next to a bgzipped file turns the scan into a seek + short
        # stream (records before the region may still appear; the position
        # filter below handles them)
        voff = None
        if self.vcf_file.endswith(".gz") and os.path.exists(self.vcf_file + ".tbi"):
            try:
                from phlash_tpu_torch.io.tabix import region_start_voff

                voff = region_start_voff(
                    self.vcf_file + ".tbi", self.contig, start, end
                )
                if voff is None:  # indexed, and nothing overlaps the region
                    return dict(het_matrix=H.astype(np.int8), afs=afs[1:-1])
            except Exception:  # pragma: no cover - malformed index: full scan
                logger.warning("unreadable .tbi for %s; scanning", self.vcf_file)
                voff = None

        def scan(early_stop: bool) -> bool:
            "Accumulate into H/afs; returns False if disorder forces a rescan."
            seen_region = False
            last_pos = -1
            for block in self._iter_line_blocks(voff if early_stop else None):
                parsed = parse_vcf_lines(block, cols, contig=self.contig)
                if parsed is None:  # pragma: no cover - backend vanished mid-file
                    raise _FastPathUnavailable
                pos, het, nd = parsed
                if len(pos) == 0:
                    if seen_region and early_stop:
                        break  # sorted VCF: the contig's section has ended
                    continue
                if early_stop and (
                    pos[0] < last_pos or bool((np.diff(pos) < 0).any())
                ):
                    # the early-stop scan assumes coordinate-sorted records;
                    # rescan the whole file rather than silently drop any
                    logger.warning(
                        "%s: records are not coordinate-sorted; falling back "
                        "to a full scan",
                        self.vcf_file,
                    )
                    return False
                last_pos = int(pos[-1])
                keep = (pos >= start) & (pos <= end)
                past = bool((pos > end).any())
                pos_k, het_k, nd_k = pos[keep], het[keep][:, order], nd[keep]
                if len(pos_k):
                    seen_region = True
                    _accumulate_windows(
                        H, afs, pos_k, het_k, nd_k, start, window_size
                    )
                if past and early_stop:
                    break  # sorted VCF: everything further is beyond the interval
            return True

        try:
            # early-stopping (skipping blocks after the region has been
            # passed) is only sound on coordinate-sorted input.  A tabix
            # index proves sortedness (tabix refuses unsorted files), so
            # early-stop exactly when one supplied a seek offset; without
            # an index every block is scanned, which is order-independent.
            # The in-scan monotonicity check stays as a safety net for an
            # index paired with a mismatched/rewritten data file — it
            # cannot see disorder past an early-stop break, which is why
            # it is not the primary guard.
            if not scan(early_stop=voff is not None):
                H[:] = False
                afs[:] = 0
                scan(early_stop=False)
        except _FastPathUnavailable:  # pragma: no cover
            return None
        return dict(het_matrix=H.astype(np.int8), afs=afs[1:-1])

    def _get_data_fast_bcf(self, window_size: int) -> dict[str, np.ndarray]:
        "Vectorized .bcf windowing over io.bcf.read_bcf_region batches."
        from phlash_tpu_torch.io.bcf import read_bcf_region

        start, end = self.interval
        S = len(self.samples)
        W = (end - start + 1) // window_size
        H = np.zeros([S, W], dtype=bool)
        afs = np.zeros(2 * S + 1, dtype=np.int64)
        for pos, het, nd in read_bcf_region(
            self.vcf_file, self.contig, start, end, self.samples
        ):
            _accumulate_windows(H, afs, pos, het, nd, start, window_size)
        return dict(het_matrix=H.astype(np.int8), afs=afs[1:-1])

    def get_data(self, window_size: int = 100) -> dict[str, np.ndarray]:
        fast = self._get_data_fast(window_size)
        if fast is not None:
            return fast
        start, end = self.interval
        L = end - start + 1
        S = len(self.samples)
        afs = np.zeros(2 * S + 1, dtype=np.int64)
        H = np.zeros([S, L // window_size], dtype=bool)
        for rec in self._records(start, end):
            col = min(H.shape[1] - 1, (rec["pos"] - start) // window_size)
            H[:, col] |= rec["het"] > 0
            afs[rec["nd"]] += 1
        return dict(het_matrix=H.astype(np.int8), afs=afs[1:-1])


# ---------------------------------------------------------------------------
# factory + batched preparation
# ---------------------------------------------------------------------------


def contig(src, samples=None, region: str = None) -> Contig:
    """Build a Contig from a path (VCF/BCF/tree-sequence/psmcfa) or an
    in-memory tskit.TreeSequence.

    VCF inputs require region="chr:start-end"; tree sequences take node-pair
    samples and no region.
    """
    if isinstance(src, str) and any(src.endswith(x) for x in (".vcf", ".vcf.gz", ".bcf")):
        if region is None or not re.match(r"\w+:\d+-\d+", region):
            raise ValueError(
                'VCF input requires a bcftools-style region, e.g. "chr1:1000-5000"'
            )
        chrom, span = region.split(":")
        a, b = map(int, span.split("-"))
        try:
            return VcfContig(src, samples=samples, contig=chrom, interval=(a, b))
        except Exception as e:
            raise ValueError(f"loading {src} as VCF failed") from e

    ts = None
    if isinstance(src, str) and (src.endswith(".trees") or src.endswith(".ts")):
        import tskit

        ts = tskit.load(src)
    elif isinstance(src, str) and (src.endswith(".tsz") or src.endswith(".tszip")):
        import tszip

        ts = tszip.decompress(src)
    elif not isinstance(src, str):
        ts = src  # assume an in-memory tree sequence
    if ts is None:
        raise ValueError(f"unrecognized input: {src}")
    if region is not None:
        raise ValueError(
            "regions are not supported for tree sequences; use "
            "TreeSequence.keep_intervals() first"
        )
    return TreeSequenceContig(ts, nodes=samples)


def subsample_chrom(chrom_path: str, populations: tuple[int, ...]):
    "Convenience: load a tszip chromosome and keep diploids from given populations."
    import tszip

    ts = tszip.decompress(chrom_path)
    nodes = [
        tuple(ind.nodes)
        for ind, pop in zip(ts.individuals(), ts.individual_populations)
        if pop in populations
    ]
    flat = [x for pair in nodes for x in pair]
    assert flat
    ts, remap = ts.simplify(samples=flat, map_nodes=True)
    nodes = [(remap[a], remap[b]) for a, b in nodes]
    pos = ts.tables.sites.position
    ts = ts.keep_intervals([[pos.min(), pos.max()]]).trim()
    return contig(ts, samples=nodes)


def init_mcmc_data(
    data: list[Contig],
    window_size: int,
    overlap: int,
    chunk_size: int = None,
    max_samples: int = 20,
    num_workers: int = None,
):
    """Chunk all contigs; return (summed AFS or None, stacked int8 chunks).

    chunk_size defaults to ~1/5 of the shortest contig (in windows).  With
    num_workers != 1 and two or more contigs to read from files (any but a
    RawContig), those are read and chunked in a spawn-context pool of
    num_workers processes (None: one per CPU).  A contig without a het
    matrix adds only its AFS; the AFS is None when no contig carries one.
    max_samples is accepted and unused, as in phlash_tpu.
    """
    if all(ds.L is None for ds in data):
        raise ValueError("none of the contigs have a length")
    if chunk_size is None:
        chunk_size = int(min(0.2 * ds.L / window_size for ds in data if ds.L))
    if chunk_size < 10 * overlap:
        logger.warning("chunk size %d is less than 10x the overlap (%d)", chunk_size, overlap)
    kw = dict(overlap=overlap, chunk_size=chunk_size, window_size=window_size)
    # the pool reads the contigs that have a file behind them, when there
    # are two or more; a RawContig is in memory already, and a worker would
    # only copy it there and back (phlash_tpu sends it all the same)
    to_read = [i for i, ds in enumerate(data) if not isinstance(ds, RawContig)]
    read = {}
    if num_workers != 1 and len(to_read) > 1:
        logger.debug("reading %d contigs in a pool of %s workers", len(to_read), num_workers)
        with CpuProcessPoolExecutor(num_workers) as pool:
            futs = {i: pool.submit(data[i].to_chunked, **kw) for i in to_read}
            read = {i: f.result() for i, f in futs.items()}
    results = [read[i] if i in read else ds.to_chunked(**kw) for i, ds in enumerate(data)]
    afss = [d.afs for d in results if d.afs is not None]
    chunk_blocks = [d.chunks for d in results if d.chunks is not None]
    if len({a.shape for a in afss}) > 1:
        raise ValueError("all AFS must have the same dimension")
    if not chunk_blocks:
        raise ValueError("none of the contigs has a het matrix")
    # no contig carried an AFS (e.g. multi-sample continuous-SMC' draws):
    # the likelihood simply drops its AFS term
    return (np.sum(afss, 0) if afss else None), np.concatenate(chunk_blocks, 0)
