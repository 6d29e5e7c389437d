"""The slice end to end on the CPU (phlash_tpu_torch.psmc with the plain
kernel versions), ingestion against phlash_tpu, the import boundary, and the
options and devices the port refuses (the fit options it implements are
tested in test_torch_fit_options.py)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import phlash_tpu_torch
from phlash_tpu_torch.data import RawContig, chunk_het_matrix, init_mcmc_data
from phlash_tpu_torch.kernel import get_kernel

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def psmcfa(tmp_path_factory):
    "3 contigs x 3000 windows of Bernoulli(0.05) hets with a missing block."
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("psmcfa") / "small.psmcfa"
    with open(path, "w") as f:
        for k in range(3):
            seq = np.where(rng.random(3000) < 0.05, "K", "T")
            seq[1000:1100] = "N"
            f.write(f">chr{k}\n")
            for lo in range(0, 3000, 60):
                f.write("".join(seq[lo: lo + 60]) + "\n")
    return str(path)


def test_psmc_cpu_plain(psmcfa):
    "8 particles, chunks of 400 + 50, 5 iterations: 8 finite models."
    models = phlash_tpu_torch.psmc([psmcfa], device="cpu", kernel_backend="smc",
                                   num_particles=8, chunk_size=400, overlap=50, niter=5)
    assert len(models) == 8
    for m in models:
        assert isinstance(m, phlash_tpu_torch.DemographicModel)
        assert m.eta.t.shape == m.eta.c.shape == (16,)
        assert torch.isfinite(m.eta.t).all() and torch.isfinite(m.eta.c).all()
        assert (m.eta.c > 0).all() and np.isfinite(m.rho) and m.theta > 0


def test_ingestion_matches_jax(psmcfa):
    "psmcfa parsing, chunking and the stacked chunk tensor equal phlash_tpu's."
    from phlash_tpu import data as jdata

    ours = list(RawContig.from_psmcfa_iter(psmcfa, 100))
    theirs = list(jdata.RawContig.from_psmcfa_iter(psmcfa, 100))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.het_matrix, b.het_matrix)
        np.testing.assert_array_equal(
            chunk_het_matrix(a.het_matrix, 50, 400), jdata.chunk_het_matrix(b.het_matrix, 50, 400)
        )
    afs, ch = init_mcmc_data(ours, 100, 50, 400)
    jafs, jch = jdata.init_mcmc_data(theirs, 100, 50, 400, num_workers=1)
    np.testing.assert_array_equal(ch, jch)
    np.testing.assert_array_equal(afs, jafs)


def test_import_leaves_jax_out():
    "Importing the port loads neither JAX nor phlash_tpu."
    code = ("import sys, phlash_tpu_torch, phlash_tpu_torch.convert, phlash_tpu_torch.cband, "
            "phlash_tpu_torch.hmm, phlash_tpu_torch.ppoly, phlash_tpu_torch.repro, "
            "phlash_tpu_torch.results, phlash_tpu_torch.sim, phlash_tpu_torch.data, "
            "phlash_tpu_torch.io, phlash_tpu_torch.io.bcf, phlash_tpu_torch.io.tabix, "
            "phlash_tpu_torch.mp, phlash_tpu_torch.plot, phlash_tpu_torch.liveplot, "
            "phlash_tpu_torch.__main__, phlash_tpu_torch.parallel, "
            "phlash_tpu_torch.parallel.mesh, phlash_tpu_torch.profiling, "
            "phlash_tpu_torch.ops.peak; "
            "from phlash_tpu_torch.sim import simulate_hmm, simulate_dataset, hmm_path_stats, "
            "stdpopsim_dataset, simulate_scrm, parse_scrm_stream, compute_truth; "
            "from phlash_tpu_torch.parallel import make_mesh, shard_training_step; "
            "phlash_tpu_torch.fit, phlash_tpu_torch.contig, phlash_tpu_torch.plot_posterior; "
            "bad = [m for m in ('jax', 'phlash_tpu') if m in sys.modules]; "
            "sys.exit(f'imported {bad}' if bad else 0)")
    path = os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_cuda_requests_raise_without_a_card(psmcfa):
    "No silent CPU fallback: asking for CUDA without a card raises."
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    data = np.zeros((2, 16), np.int8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_kernel(16, data, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        phlash_tpu_torch.psmc([psmcfa], num_particles=4, chunk_size=400, overlap=50, niter=1)


@pytest.mark.parametrize("device,backend", [("cpu", "cuda"), ("cpu", "plain")])
def test_backend_device_mismatch_raises(device, backend):
    "A backend names an algorithm, not a device: the device names are refused."
    with pytest.raises(ValueError, match="unknown kernel backend"):
        get_kernel(16, np.zeros((2, 16), np.int8), device=device, backend=backend)


@pytest.mark.parametrize("option,error", [
    pytest.param(dict(mesh=object()), TypeError, id="mesh"),
    pytest.param(dict(key=7), NotImplementedError, id="key"),
])
def test_unimplemented_options_raise(psmcfa, option, error):
    """key has no counterpart (seed= does its work); mesh is implemented
    (tests/test_torch_parallel.py) and refuses what is not a DeviceMesh."""
    with pytest.raises(error):
        phlash_tpu_torch.psmc([psmcfa], device="cpu", niter=1, **option)


def test_unknown_option_raises(psmcfa):
    with pytest.raises(TypeError, match="unknown option"):
        phlash_tpu_torch.psmc([psmcfa], device="cpu", niter=1, num_particle=4)


def test_version_is_phlash_tpus():
    "phlash_tpu_torch.__version__ is phlash_tpu's (pyproject.toml's), beside the lazy names."
    import phlash_tpu

    assert phlash_tpu_torch.__version__ == phlash_tpu.__version__ == "0.1.0"
    assert "__version__" in dir(phlash_tpu_torch) and "fit" in dir(phlash_tpu_torch)
