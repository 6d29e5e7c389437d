"""Ingestion of phlash_tpu_torch.data against phlash_tpu.data: the same files
(made from a numpy seed) through both packages give equal het matrices and
AFS, bit for bit; the contig types, contig()'s errors, init_mcmc_data with
its worker pool, the density with a live AFS term, and a short fit from a
VCF."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import gzip
import logging
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import phlash_tpu.data as jdata
import phlash_tpu.io.fastvcf as jfastvcf
import phlash_tpu.io.tabix as jtabix
import phlash_tpu_torch
import phlash_tpu_torch.data as tdata
import phlash_tpu_torch.io.fastvcf as tfastvcf
import phlash_tpu_torch.io.tabix as ttabix
from phlash_tpu.model import log_density_batched as jax_log_density
from phlash_tpu.ops.kernel_dense import DenseKernel
from phlash_tpu_torch import convert
from phlash_tpu_torch.model import log_density_batched
from phlash_tpu_torch.ops.kernel_smc import SMCKernel
from phlash_tpu_torch.training import batched_grad

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "sample.bcf"
PACKAGES = {"torch": (tdata, tfastvcf, ttabix), "jax": (jdata, jfastvcf, jtabix)}
HEADER = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
GTS = ["0/0", "0/1", "1/1", "./.", "0|1", "1|0", "1|1", ".|1"]


def _vcf_text(rng, samples, contigs=("chr1", "chr2"), n=400, span=60_000, unsorted=False):
    "Random multi-sample VCF text: missing calls, phased and unphased."
    lines = [HEADER + "\t".join(samples)]
    for chrom in contigs:
        pos = np.sort(rng.choice(np.arange(1, span), n, replace=False))
        if unsorted:
            pos = rng.permutation(pos)
        for p in pos:
            lines.append(f"{chrom}\t{p}\t.\tA\tT\t.\tPASS\t.\tGT\t"
                         + "\t".join(rng.choice(GTS, len(samples))))
    return "\n".join(lines) + "\n"


def _write(path: Path, text: str) -> str:
    if path.name.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path)


# Each case writes its input under `tmp` once (the same file for both
# packages) and returns a function (data module, fastvcf module, tabix
# module, monkeypatch) -> list of get_data dicts.
def _vcf_case(name, parser, region="chr2:5000-50000", **kw):
    def case(tmp, rng):
        samples = ["sA", "sB", "sC"]
        path = _write(tmp / name, _vcf_text(rng, samples, **kw))

        def run(data, fastvcf, tabix, mp):
            if parser == "python":
                mp.setattr(fastvcf, "_load", lambda: None)
            return [data.contig(path, samples, region).get_data(100)]
        return run
    return case


def _stream_case(tmp, rng):
    samples = ["sA", "sB"]
    path = _write(tmp / "s.vcf.gz", _vcf_text(rng, samples, n=3000, span=400_000,
                                              contigs=("chr0", "chr1", "chr2")))

    def run(data, fastvcf, tabix, mp):
        mp.setattr(data.VcfContig, "_STREAM_BLOCK", 1 << 12)  # lines split across blocks
        return [data.contig(path, samples, "chr1:1-300000").get_data(100)]
    return run


def _tabix_case(region, unsorted_index=False):
    def case(tmp, rng):
        samples = ["sA", "sB"]
        path = str(tmp / "t.vcf.gz")
        text = _vcf_text(rng, samples, n=2000, span=300_000, contigs=("chr0", "chr1", "chr2"),
                         unsorted=unsorted_index)
        if unsorted_index:  # an index beside a file it does not describe
            _write(Path(path), text)
            Path(path + ".tbi").write_bytes(b"")
        else:
            ttabix.write_tabixed_vcf(path, text)

        def run(data, fastvcf, tabix, mp):
            if unsorted_index:
                mp.setattr(tabix, "region_start_voff", lambda *a, **k: 0)
            return [data.contig(path, samples, region).get_data(100)]
        return run
    return case


def _bcf_fixture(tmp, rng):
    def run(data, fastvcf, tabix, mp):
        return [data.contig(str(FIXTURE), ["sampleA", "sampleB"], "chr1:1-1000000").get_data(100),
                data.contig(str(FIXTURE), ["sampleB"], "chr2:100000-400000").get_data(100)]
    return run


def _bcf_written(record_path):
    def case(tmp, rng):
        from phlash_tpu_torch.io.bcf import write_bcf

        header = ('##fileformat=VCFv4.2\n##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">\n'
                  "##contig=<ID=chr1,length=5000>\n" + HEADER + "s0\ts1\n")
        recs = []
        for pos in sorted(rng.choice(np.arange(1, 5000), size=300, replace=False)):
            gts = [tuple(int(a) for a in rng.integers(0, 2, 2)) for _ in range(2)]
            if pos % 97 == 0:
                gts[0] = (None, None)  # a missing call
            if pos % 131 == 0:
                gts = [(1,), (0,)]  # a haploid record: the layout changes mid-stream
            recs.append(("chr1", int(pos), "A", ["T"], gts))
        path = str(tmp / "mix.bcf")
        write_bcf(path, header, recs, index=True)

        def run(data, fastvcf, tabix, mp):
            if record_path:
                mp.setattr(data.VcfContig, "_get_data_fast", lambda self, w: None)
            return [data.VcfContig(path, samples=["s0", "s1"], contig="chr1",
                                   interval=(100, 4500)).get_data(100)]
        return run
    return case


def _psmcfa(tmp, rng):
    path = tmp / "x.psmcfa"
    with open(path, "w") as f:
        for k in range(2):
            seq = rng.choice(list("TTTTKN"), 700)
            f.write(f">chr{k}\n" + "\n".join("".join(seq[i: i + 60]) for i in range(0, 700, 60))
                    + "\n")

    def run(data, fastvcf, tabix, mp):
        return [c.get_data(100) for c in data.RawContig.from_psmcfa_iter(str(path), 100)]
    return run


class _FakeTS:
    """Duck-typed tskit.TreeSequence (tskit is optional): exactly the members
    TreeSequenceContig uses, as in tests/test_data.py."""

    def __init__(self, rng, L=1000, n_hap=6, n_sites=60):
        self._L = L
        self._pos = np.sort(rng.choice(np.arange(1, L), size=n_sites, replace=False))
        self._g = rng.integers(0, 2, size=(n_sites, n_hap))
        self.num_sites = n_sites

    def get_sequence_length(self):
        return float(self._L)

    def individuals(self):
        class Ind:
            def __init__(self, nodes):
                self.nodes = nodes
        return [Ind((2 * i, 2 * i + 1)) for i in range(self._g.shape[1] // 2)]

    def variants(self, samples, copy=False):
        class Var:
            def __init__(self, position, genotypes):
                self.position, self.genotypes = position, genotypes
        cols = np.asarray(samples)
        for p, row in zip(self._pos, self._g):
            yield Var(p, row[cols])

    def allele_frequency_spectrum(self, sample_sets, windows, polarised, span_normalise):
        (sset,) = sample_sets
        counts = self._g[:, np.asarray(sset)].sum(1)
        out = np.zeros((len(windows) - 1, len(sset) + 1))
        w = np.searchsorted(np.asarray(windows), self._pos, side="right") - 1
        for wi, k in zip(w, counts):
            out[wi, k] += 1
        return out


def _ts_case(nodes=None, mask=None):
    def case(tmp, rng):
        ts = _FakeTS(rng)

        def run(data, fastvcf, tabix, mp):
            c = data.contig(ts, samples=nodes) if mask is None else \
                data.TreeSequenceContig(ts, nodes=nodes, mask=mask)
            assert c.N == 2 * len(nodes or ts.individuals()) and c.L == 1000
            return [c.get_data(100)]
        return run
    return case


CASES = {
    "psmcfa": _psmcfa,
    "vcf-c": _vcf_case("t.vcf", "c"),
    "vcf.gz-c": _vcf_case("t.vcf.gz", "c"),
    "vcf-python": _vcf_case("t.vcf", "python"),
    "vcf.gz-python": _vcf_case("t.vcf.gz", "python"),
    "vcf-unsorted-c": _vcf_case("u.vcf", "c", unsorted=True),
    "stream-blocks": _stream_case,
    "tabix-region": _tabix_case("chr1:50000-200000"),
    "tabix-empty-region": _tabix_case("chr2:1000000-2000000"),
    "tabix-unsorted-rescan": _tabix_case("chr1:1-300000", unsorted_index=True),
    "bcf-fixture": _bcf_fixture,
    "bcf-written": _bcf_written(record_path=False),
    "bcf-record-path": _bcf_written(record_path=True),
    "ts-all": _ts_case(),
    "ts-node-subset": _ts_case(nodes=[(0, 3), (4, 5)]),
    "ts-mask": _ts_case(mask=[(200, 400), (850, 900)]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_ingestion_matches_jax(name, tmp_path, monkeypatch):
    "Het matrix and AFS equal phlash_tpu.data's bit for bit (values and dtypes)."
    run = CASES[name](tmp_path, np.random.default_rng(sum(map(ord, name))))
    got = {}
    for pkg, mods in PACKAGES.items():
        with monkeypatch.context() as mp:
            got[pkg] = run(*mods, mp)
    assert len(got["torch"]) == len(got["jax"]) > 0
    for ours, theirs in zip(got["torch"], got["jax"]):
        for k in ("het_matrix", "afs"):
            np.testing.assert_array_equal(ours[k], theirs[k])
            assert ours[k].dtype == theirs[k].dtype, k
    if name != "tabix-empty-region":
        assert any(d["het_matrix"].any() for d in got["torch"])


def test_unsorted_index_warns_and_rescans(tmp_path, monkeypatch, caplog):
    "An index over an unsorted file is caught in the scan: warning, full rescan."
    run = _tabix_case("chr1:1-300000", unsorted_index=True)(tmp_path, np.random.default_rng(3))
    with caplog.at_level(logging.WARNING, logger="phlash_tpu_torch.data"):
        d = run(*PACKAGES["torch"], monkeypatch)[0]
    assert "not coordinate-sorted" in caplog.text and d["het_matrix"].any()


@pytest.mark.parametrize("src,kw,match", [
    ("x.vcf", dict(samples=["sA"]), "region"),
    ("x.vcf.gz", dict(samples=["sA"], region="chr1"), "region"),
    ("x.bcf", dict(samples=[], region="chr1:1-100"), "as VCF failed"),
    ("x.vcf", dict(samples=[1, 2], region="chr1:1-100"), "as VCF failed"),
    ("x.vcf", dict(samples=["sA"], region="chr1:100-100"), "as VCF failed"),
    ("x.fasta", dict(), "unrecognized input"),
], ids=["no-region", "bad-region", "no-samples", "non-string-samples", "empty-interval",
        "unknown-input"])
def test_contig_errors(src, kw, match):
    "contig() refuses what phlash_tpu.data.contig refuses, with the same error."
    for data in (tdata, jdata):
        with pytest.raises(ValueError, match=match):
            data.contig(src, **kw)


def test_tree_sequence_regions_refused():
    with pytest.raises(ValueError, match="regions are not supported"):
        tdata.contig(_FakeTS(np.random.default_rng(0)), region="chr1:1-10")
    with pytest.raises(ValueError, match="nodes"):
        tdata.TreeSequenceContig(_FakeTS(np.random.default_rng(0)), nodes=[(0, 1, 2)])


def test_raw_contig_properties():
    "N (two ploids a row), L, size, and a contig without a het matrix."
    c = tdata.RawContig(het_matrix=np.zeros((3, 50), np.int8), afs=np.ones(5), window_size=100)
    assert (c.N, c.L, c.size) == (6, 5000, 30000)
    empty = tdata.RawContig(het_matrix=None, afs=np.arange(1, 6), window_size=100)
    assert empty.N is None and empty.L is None and empty.size is None
    ch = empty.to_chunked(overlap=5, chunk_size=20, window_size=100)
    assert ch.chunks is None and list(ch.afs) == [1, 2, 3, 4, 5]
    raw = c.to_raw(100)
    assert isinstance(raw, tdata.RawContig) and raw.N == 6
    with pytest.raises(ValueError, match="window_size"):
        c.get_data(50)


def _raw_contigs(rng, with_afs=True):
    return [tdata.RawContig(het_matrix=rng.integers(-1, 2, (2, 3000)).astype(np.int8),
                            afs=rng.integers(0, 9, 5) if with_afs else None, window_size=100)
            for _ in range(3)]


def test_init_mcmc_data_skips_contigs_without_het_matrix():
    """A contig without a het matrix adds only its AFS; no AFS anywhere gives
    None; equal to phlash_tpu's."""
    rng = np.random.default_rng(4)
    contigs = _raw_contigs(rng) + [tdata.RawContig(None, np.arange(5), 100)]
    afs, ch = tdata.init_mcmc_data(contigs, 100, 50, 400, num_workers=1)
    jcontigs = [jdata.RawContig(c.het_matrix, c.afs, 100) for c in contigs]
    jafs, jch = jdata.init_mcmc_data(jcontigs, 100, 50, 400, num_workers=1)
    np.testing.assert_array_equal(afs, jafs)
    np.testing.assert_array_equal(ch, jch)
    none_afs, _ = tdata.init_mcmc_data(_raw_contigs(rng, with_afs=False), 100, 50, 400,
                                       num_workers=1)
    assert none_afs is None
    with pytest.raises(ValueError, match="same dimension"):
        tdata.init_mcmc_data(contigs + [tdata.RawContig(None, np.ones(3), 100)], 100, 50, 400,
                             num_workers=1)


def test_init_mcmc_data_pool_equals_serial(tmp_path, monkeypatch):
    """num_workers=2 (a spawn pool reading two VCF regions, a RawContig
    chunked in-process between them) equals num_workers=1, and phlash_tpu's
    result."""
    samples = ["sA", "sB", "sC"]
    path = _write(tmp_path / "p.vcf.gz", _vcf_text(np.random.default_rng(9), samples))
    regions = ["chr1:1-60000", "chr2:1-60000"]
    raw = tdata.RawContig(np.random.default_rng(1).integers(0, 2, (3, 500)).astype(np.int8),
                          np.arange(1, 6), 100)
    contigs = [tdata.contig(path, samples, regions[0]), raw, tdata.contig(path, samples,
                                                                          regions[1])]
    pooled = tdata.init_mcmc_data(contigs, 100, 20, 100, num_workers=2)
    serial = tdata.init_mcmc_data(contigs, 100, 20, 100, num_workers=1)
    theirs = jdata.init_mcmc_data([jdata.contig(path, samples, regions[0]),
                                   jdata.RawContig(raw.het_matrix, raw.afs, 100),
                                   jdata.contig(path, samples, regions[1])], 100, 20, 100,
                                  num_workers=1)
    for a, b, c in zip(pooled, serial, theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # contigs already in memory never start a pool
    monkeypatch.setattr(tdata, "CpuProcessPoolExecutor", None)
    in_memory = tdata.init_mcmc_data([raw, raw], 100, 20, 100, num_workers=2)
    np.testing.assert_array_equal(in_memory[1],
                                  np.concatenate([tdata.chunk_het_matrix(raw.het_matrix, 20, 100)] * 2))


def test_worker_imports_leave_torch_out():
    """A pool worker imports the package, mp and data (to unpickle its task):
    none of them imports torch, JAX or phlash_tpu."""
    code = ("import sys, phlash_tpu_torch, phlash_tpu_torch.mp, phlash_tpu_torch.data, "
            "phlash_tpu_torch.io; "
            "bad = [m for m in ('torch', 'jax', 'phlash_tpu') if m in sys.modules]; "
            "sys.exit(f'imported {bad}' if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                       os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def _eight_sample_vcf(tmp_path) -> tuple[str, list[str]]:
    "8 diploids, 120,000 bp: a dense het pattern with a spread of derived counts."
    rng = np.random.default_rng(11)
    samples = [f"s{i}" for i in range(8)]
    lines = [HEADER + "\t".join(samples)]
    for p in np.sort(rng.choice(np.arange(1, 120_000), 900, replace=False)):
        code = rng.choice(3, 8, p=[0.5, 0.3, 0.2])
        lines.append(f"chr1\t{p}\t.\tA\tT\t.\tPASS\t.\tGT\t"
                     + "\t".join(("0|0", "0|1", "1|1")[k] for k in code))
    return _write(tmp_path / "eight.vcf", "\n".join(lines) + "\n"), samples


def test_log_density_with_live_afs_matches_jax(tmp_path, mcp):
    """log_density_batched on chunks and the AFS (n = 16) of an 8-sample VCF,
    float64, against phlash_tpu's (dense kernel): values and per-particle
    gradients within test_torch_model.py's 1e-6 with the AFS term (phlash_tpu
    evaluates that term in float32)."""
    from jax.flatten_util import ravel_pytree

    path, samples = _eight_sample_vcf(tmp_path)
    afs, chunks = tdata.init_mcmc_data([tdata.contig(path, samples, "chr1:1-120000")], 100, 40,
                                       120)
    assert len(afs) == 15 and (afs > 0).sum() > 8
    inds = np.array([0, 5, 9])
    body = chunks[:, 40:]
    flat, unravel = ravel_pytree(mcp)
    draws = np.asarray(flat)[None] + 0.2 * np.random.default_rng(0).standard_normal(
        (3, flat.shape[0]))
    jm = jax.vmap(unravel)(jnp.asarray(draws))
    kw = dict(c=jnp.asarray([1.0, 2.0, 1.0]), inds=jnp.asarray(inds),
              warmup=jnp.asarray(chunks[inds, :40]),
              kern=DenseKernel(M=16, data=body, double_precision=True), afs=jnp.asarray(afs))

    def total(P):
        v = jax_log_density(P, **kw)
        return v.sum(), v

    (_, want), want_g = jax.jit(jax.value_and_grad(total, has_aux=True))(jm)
    want_g = np.asarray(jax.vmap(lambda m: ravel_pytree(m)[0])(want_g))
    tm = convert.from_reference_mcmc(jm)
    tkw = dict(c=(1.0, 2.0, 1.0), inds=torch.as_tensor(inds),
               warmup=torch.as_tensor(chunks[inds, :40]), kern=SMCKernel(16, body, device="cpu"),
               afs=torch.as_tensor(afs, dtype=torch.float64))
    got = log_density_batched(tm, **tkw)
    got_g = batched_grad(tm)(tm.flatten(), **tkw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-6, atol=1e-6 * np.abs(want_g).max())


def test_fit_from_vcf_cpu(tmp_path):
    """A 3-iteration fit from VcfContigs with the AFS term live and the
    held-out ELPD on a second region: finite models."""
    path, samples = _eight_sample_vcf(tmp_path)
    train = [phlash_tpu_torch.contig(path, samples, "chr1:1-80000")]
    test = phlash_tpu_torch.contig(path, samples, "chr1:80001-120000")
    models = phlash_tpu_torch.fit(train, test_data=test, device="cpu", num_particles=6, niter=3,
                                  overlap=20, chunk_size=100, progress=False)
    assert len(models) == 6
    for m in models:
        assert torch.isfinite(m.eta.t).all() and torch.isfinite(m.eta.c).all()
        assert (m.eta.c > 0).all() and np.isfinite(m.rho)


def test_fit_default_is_the_card(tmp_path):
    "fit from a VcfContig defaults to CUDA: without a card it raises."
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    path, samples = _eight_sample_vcf(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        phlash_tpu_torch.fit([phlash_tpu_torch.contig(path, samples, "chr1:1-80000")], niter=1)


def test_chip_smoke_genome_files_rehearsal(tmp_path):
    """chip_smoke.py phase 7a-b at a small size: the writers' three forms
    ingest to the planted het matrix and the records' AFS exactly."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from phlash_tpu_torch import sim

    samples = [f"s{i}" for i in range(4)]
    truth = sim.bottleneck_demography()
    planted = {c: sim.simulate_smc_continuous(truth, L=20_000, n_samples=4, seed=k).het_matrix
               for k, c in enumerate(("chr1", "chr2"))}
    paths, spectra, _ = chip_smoke.write_genome_files(tmp_path, planted, samples, seed=5)
    assert set(paths) == {"vcf.gz", "vcf", "bcf"} and Path(str(paths["bcf"]) + ".csi").exists()
    assert len(spectra["chr1"]) == 7 and spectra["chr1"].sum() == planted["chr1"].any(0).sum()
    for chrom in planted:
        seconds = chip_smoke.check_ingestion(paths, planted, spectra, samples, chrom)
        assert set(seconds) == set(paths)


def test_package_exports_resolve_to_functions():
    """The package's names resolve when first used, and `psmc` stays the
    function after its submodule is imported by name."""
    code = ("import phlash_tpu_torch.psmc, phlash_tpu_torch as p, phlash_tpu_torch.plot; "
            "assert callable(p.psmc) and callable(p.plot_posterior) and callable(p.contig); "
            "assert all(hasattr(p, n) for n in p.__all__), p.__all__; "
            "assert set(p.__all__) == {'fit', 'contig', 'psmc', 'DemographicModel', "
            "'SizeHistory', 'confidence_band', 'plot_posterior', 'save_posterior', "
            "'load_posterior'}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                       os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout
