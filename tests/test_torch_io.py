"""The readers and writers of phlash_tpu_torch.io against phlash_tpu.io on the
same inputs: BGZF / BCF / CSI and tabix files written byte for byte alike,
read_csi / read_tbi / region_start_voff / iter_bcf / read_bcf_region /
parse_vcf_lines equal; and the tokenizer's build (hash-keyed, atomic, into
phlash_tpu_torch/_build/)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ctypes
import threading
from pathlib import Path

import numpy as np

import phlash_tpu.io.bcf as jbcf
import phlash_tpu.io.fastvcf as jfastvcf
import phlash_tpu.io.tabix as jtabix
import phlash_tpu_torch.io.bcf as tbcf
import phlash_tpu_torch.io.fastvcf as tfastvcf
import phlash_tpu_torch.io.tabix as ttabix

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = str(ROOT / "tests" / "fixtures" / "sample.bcf")
GT_HEADER = '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'


def _records(rng, contigs=("c1", "c2"), n=500, samples=3):
    out = []
    for chrom in contigs:
        for pos in np.sort(rng.choice(np.arange(1, 200_000), n, replace=False)):
            gts = [tuple(int(a) for a in rng.integers(0, 3, 2)) for _ in range(samples)]
            if pos % 7 == 0:
                gts[0] = (None, None)
            out.append((chrom, int(pos), "A", ["T", "G"], gts))
    return out


def _header(contigs=("c1", "c2"), samples=3):
    return ("##fileformat=VCFv4.2\n" + GT_HEADER
            + "".join(f"##contig=<ID={c},length=200000>\n" for c in contigs)
            + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + "\t".join(f"s{i}" for i in range(samples)) + "\n")


def _vcf_text(records, header):
    def gt(g):
        return "/".join("." if a is None else str(a) for a in g)
    return header + "".join(f"{c}\t{p}\t.\t{r}\t{','.join(a)}\t.\tPASS\t.\tGT\t"
                            + "\t".join(gt(g) for g in gts) + "\n"
                            for c, p, r, a, gts in records)


def test_write_bcf_and_read_csi_match_jax(tmp_path):
    "write_bcf(index=True) writes the same bytes; read_csi reads the same index."
    recs, header = _records(np.random.default_rng(1)), _header()
    for mod, name in ((tbcf, "t.bcf"), (jbcf, "j.bcf")):
        mod.write_bcf(str(tmp_path / name), header, recs, index=True)
    for ext in ("", ".csi"):
        assert (tmp_path / f"t.bcf{ext}").read_bytes() == (tmp_path / f"j.bcf{ext}").read_bytes()
    assert tbcf.read_csi(str(tmp_path / "t.bcf.csi")) == jbcf.read_csi(str(tmp_path / "j.bcf.csi"))


def test_read_csi_fixture_matches_jax():
    assert tbcf.read_csi(FIXTURE + ".csi") == jbcf.read_csi(FIXTURE + ".csi")
    with tbcf.BcfFile(FIXTURE) as ours, jbcf.BcfFile(FIXTURE) as theirs:
        assert (ours.contigs, ours.samples, ours.strings) == (theirs.contigs, theirs.samples,
                                                              theirs.strings)


@pytest.mark.parametrize("contig,start,end,samples", [
    ("chr1", 1, 1_000_000, ["sampleA", "sampleB"]),
    ("chr1", 250_000, 260_000, ["sampleB"]),
    ("chr2", 100_000, 400_000, ["sampleB", "sampleA"]),
    ("chr2", 490_000, 499_999, ["sampleA"]),
], ids=["chr1-all", "chr1-slice", "chr2-reordered", "chr2-empty-tail"])
def test_bcf_readers_match_jax(contig, start, end, samples):
    "iter_bcf and read_bcf_region over the committed fixture equal phlash_tpu's."
    ours = list(tbcf.iter_bcf(FIXTURE, contig, start, end, samples))
    theirs = list(jbcf.iter_bcf(FIXTURE, contig, start, end, samples))
    assert [r["pos"] for r in ours] == [r["pos"] for r in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a["het"], b["het"])
        assert a["nd"] == b["nd"]
    batches = [list(tbcf.read_bcf_region(FIXTURE, contig, start, end, samples, batch=333)),
               list(jbcf.read_bcf_region(FIXTURE, contig, start, end, samples, batch=333))]
    assert len(batches[0]) == len(batches[1])
    for a, b in zip(*batches):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_bgzf_virtual_seek_matches_jax(tmp_path):
    "The BGZF writer's blocks and the reader's virtual seeks agree with phlash_tpu's."
    payload = bytes(range(256)) * 1500  # several 64 KiB blocks
    marks = {}
    for mod, name in ((tbcf, "t.bgzf"), (jbcf, "j.bgzf")):
        with open(tmp_path / name, "wb") as fh:
            w = mod._BgzfWriter(fh)
            w.write(payload[:100_000])
            marks[name] = w.tell_virtual()
            w.write(payload[100_000:])
            w.finish()
    assert (tmp_path / "t.bgzf").read_bytes() == (tmp_path / "j.bgzf").read_bytes()
    assert marks["t.bgzf"] == marks["j.bgzf"]
    r = tbcf.BgzfReader(str(tmp_path / "t.bgzf"))
    r.seek_virtual(marks["t.bgzf"])
    assert r.read(50) == payload[100_000:100_050]
    r.close()


def test_tabix_matches_jax(tmp_path):
    """write_tabixed_vcf writes the same .vcf.gz and .tbi; read_tbi and
    region_start_voff read them alike, an absent contig and an empty region
    included."""
    text = _vcf_text(_records(np.random.default_rng(2), contigs=("c0", "c1", "c2"), n=800),
                     _header(("c0", "c1", "c2")))
    for mod, name in ((ttabix, "t.vcf.gz"), (jtabix, "j.vcf.gz")):
        mod.write_tabixed_vcf(str(tmp_path / name), text)
    for ext in ("", ".tbi"):
        assert (tmp_path / f"t.vcf.gz{ext}").read_bytes() == \
            (tmp_path / f"j.vcf.gz{ext}").read_bytes()
    tbi = str(tmp_path / "t.vcf.gz.tbi")
    assert ttabix.read_tbi(tbi) == jtabix.read_tbi(tbi)
    for contig, lo, hi in [("c0", 1, 200_000), ("c1", 50_000, 60_000), ("c2", 150_000, 199_999),
                           ("c1", 500_000, 600_000), ("c9", 1, 10)]:
        assert ttabix.region_start_voff(tbi, contig, lo, hi) == \
            jtabix.region_start_voff(tbi, contig, lo, hi), (contig, lo, hi)


VCF = b"""##fileformat=VCFv4.2
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsA\tsB\tsC
chr1\t10\t.\tA\tT\t.\tPASS\t.\tGT:DP\t0/1:3\t0/0:9\t1/1:2
chr2\t11\t.\tA\tT\t.\tPASS\t.\tGT\t1/1\t0/1\t0/0
chr1\t150\t.\tG\tC\t.\tPASS\t.\tGT\t.|1\t0|1\t./.
chr1\t400\t.\tT\tA\t.\tPASS\t.\tGT\t0/0\t1/1\t0/1
chr1\tx\t.\tT\tA\t.\tPASS\t.\tGT\t0/0\t1/1\t0/1
chr1\t500\t.\tT\tA\t.\tPASS\t.\tGT\t0/1
"""


@pytest.mark.parametrize("contig,cols", [(None, [9, 10, 11]), ("chr1", [9, 11]),
                                         ("chr2", [10])], ids=["all", "chr1", "chr2"])
def test_parse_vcf_lines_matches_jax(contig, cols):
    "The C tokenizer's records equal phlash_tpu's, malformed and short lines included."
    if tfastvcf.vcf_parser_backend() != "c" or jfastvcf.vcf_parser_backend() != "c":
        pytest.skip("no C compiler: the tokenizer cannot be built")
    ours = tfastvcf.parse_vcf_lines(VCF, cols, contig=contig)
    theirs = jfastvcf.parse_vcf_lines(VCF, cols, contig=contig)
    assert len(ours[0]) > 0
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_tokenizer_build_is_hash_keyed_and_atomic(tmp_path, monkeypatch):
    """The library's name carries a hash of the source; builds racing into
    one target (as xdist workers do) each move a whole file into place, and
    the result loads and parses."""
    if tfastvcf.vcf_parser_backend() == "c":
        lib = tfastvcf._target()
        assert lib.parent == ROOT / "phlash_tpu_torch" / "_build" and lib.exists()
        assert lib.name.startswith("libphlash_fastvcf_") and len(lib.stem) == 34
    monkeypatch.setattr(tfastvcf, "BUILD_DIR", tmp_path / "_build")
    target = tfastvcf._target()
    assert target.parent == tmp_path / "_build"
    ok = []
    threads = [threading.Thread(target=lambda: ok.append(tfastvcf._build(target)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and len(ok) == 4
    if not all(ok):
        pytest.skip("no C compiler: the tokenizer cannot be built")
    assert [p.name for p in target.parent.iterdir()] == [target.name]  # no temporaries left
    ctypes.CDLL(str(target)).phlash_parse_vcf  # a whole library


def test_python_fallback_when_unbuildable(monkeypatch):
    "Without the library the backend is 'python' and the tokenizer returns None."
    monkeypatch.setattr(tfastvcf, "_load", lambda: None)
    assert tfastvcf.vcf_parser_backend() == "python"
    assert tfastvcf.parse_vcf_lines(VCF, [9]) is None
