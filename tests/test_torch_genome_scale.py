"""tools/torch_genome_scale_demo.py, the whole-genome path of
phlash_tpu_torch, at a small scale on the CPU: end to end (its JSON line,
its chunk count and its launch counts), its VCFs against
tools/genome_scale_demo.py's at the same seed, and its chunk tensor and AFS
against phlash_tpu.data.init_mcmc_data's on the same files."""

import gzip
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np

import phlash_tpu
from phlash_tpu.data import init_mcmc_data as jax_init_mcmc_data

ROOT = Path(__file__).resolve().parent.parent
SCALE = 0.0005
WINDOW, OVERLAP, CHUNK = 100, 100, 500


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load("torch_genome_scale_demo")


def test_end_to_end_on_the_cpu(tmp_path):
    """--scale 0.0005 --device cpu --particles 8 --niter 2 --holdout: every
    stage's line and the JSON last line; the chunk count is the sum over the
    21 training chromosomes of chunk_het_matrix's rows from their lengths;
    the plain versions ran exactly what 2 iterations (one a call on the
    CPU), the timed plain calls and the hold-out timing's calls imply, and
    packed nothing; the cloud is finite."""
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_genome_scale_demo.py"), "--scale",
         str(SCALE), "--device", "cpu", "--particles", "8", "--niter", "2", "--holdout"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    for stage in ("synthesis:", "ingestion:", "fit:", "device memory:", "posterior median",
                  "held-out ELPD", "card:"):
        assert any(line.startswith(stage) for line in lines[:-1]), stage
    lengths = [int(mb * 1e6 * SCALE) for mb in tool.CHROM_MB[:-1]]
    assert out["chromosome_windows"] == [L // WINDOW for L in lengths]
    span = CHUNK + OVERLAP
    assert out["chunks"] == sum(max(1, -(-(L // WINDOW) // span)) for L in lengths)
    assert out["columns"] == span and out["device"] == "cpu" and out["card"] is None
    assert out["finite"] and np.isfinite(out["median_c0"])
    assert out["steps_per_call"] == 1 and out["iterations"] == 2
    fit, timing = out["launches_fit"], out["launches_timing"]
    assert (fit["smc"]["forward_plain"], fit["smc"]["backward_plain"]) == (4, 4)
    assert (fit["assembly"]["forward_plain"], fit["assembly"]["backward_plain"]) == (2, 2)
    assert (fit["svgd"]["direction_plain"], fit["svgd"]["amsgrad_plain"]) == (2, 2)
    n = out["timed_calls"]  # plain calls of one iteration each
    assert (timing["smc"]["forward_plain"], timing["smc"]["backward_plain"]) == (2 * n, 2 * n)
    assert (timing["assembly"]["forward_plain"], timing["assembly"]["backward_plain"]) == (n, n)
    assert (timing["svgd"]["direction_plain"], timing["svgd"]["amsgrad_plain"]) == (n, n)
    e = out["elpd"]
    iters = elpds = e["elpd_calls"]
    held = out["launches_holdout"]
    assert held["smc"]["forward_plain"] == 2 * iters + 2 * elpds
    assert held["smc"]["backward_plain"] == 2 * iters
    assert held["assembly"]["forward_plain"] == iters + elpds
    assert held["assembly"]["backward_plain"] == iters
    assert held["svgd"]["amsgrad_plain"] == iters
    assert all(v == 0 for c in (fit, timing, held) for name, m in c.items()
               for k, v in m.items() if "cuda" in k or name == "packed")
    assert np.isfinite(out["ms_per_iter"]) and out["ms_per_iter"] > 0
    assert np.isfinite(e["overhead"]) and e["test_chunks"] >= 1


def test_vcfs_match_the_jax_demo(tmp_path):
    """The 22 VCFs, decompressed, are byte-equal to tools/genome_scale_demo.py's
    synth_chromosome at the same seed (gzip's header carries the time)."""
    jax_demo = _load("genome_scale_demo")
    assert tool.CHROM_MB == jax_demo.CHROM_MB
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    paths = tool.synthesize(str(tmp_path / "port"), SCALE, seed=0)
    rng = np.random.default_rng(0)
    for path, chrom, length in paths:
        want = tmp_path / "jax" / f"{chrom}.vcf.gz"
        jax_demo.synth_chromosome(str(want), chrom, length, rng)
        assert gzip.open(path).read() == gzip.open(want).read(), chrom


def test_chunks_and_afs_match_phlash_tpu(tmp_path):
    """The tool's ingestion (phlash_tpu_torch.contig, init_mcmc_data in a
    spawn pool) against phlash_tpu.contig and phlash_tpu.data.init_mcmc_data
    on the same files: chunk tensor and AFS bitwise equal."""
    paths = tool.synthesize(str(tmp_path), SCALE, seed=3)
    afs, chunks = tool.ingest(paths, WINDOW, OVERLAP, CHUNK, num_workers=2)
    contigs = [phlash_tpu.contig(p, samples=[tool.SAMPLE], region=f"{c}:1-{L}")
               for p, c, L in paths]
    want_afs, want_chunks = jax_init_mcmc_data(contigs, window_size=WINDOW, overlap=OVERLAP,
                                               chunk_size=CHUNK, num_workers=1)
    assert chunks.dtype == want_chunks.dtype and np.array_equal(chunks, want_chunks)
    assert np.array_equal(afs, want_afs)


def test_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    """The default device is cuda: without a card the tool raises once it
    has read the data (torch is imported only after the ingestion's RSS is
    read), before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(tool, "WORKERS", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--scale", str(SCALE)])


def test_tool_imports_leave_jax_out():
    """The tool and the modules this slice added or extended import neither
    JAX nor phlash_tpu."""
    code = ("import importlib.util, sys; "
            f"spec = importlib.util.spec_from_file_location('t', {str(tool.__file__)!r}); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
            "import phlash_tpu_torch.kernel_base, phlash_tpu_torch.model, "
            "phlash_tpu_torch.transition, phlash_tpu_torch.ops.kernel_smc, "
            "phlash_tpu_torch.ops.kernel_packed, phlash_tpu_torch.training; "
            "bad = [m for m in ('jax', 'phlash_tpu') if m in sys.modules]; "
            "sys.exit(f'imported {bad}' if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                       os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout
