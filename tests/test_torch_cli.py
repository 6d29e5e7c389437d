"""`python -m phlash_tpu_torch fit` on the CPU: the flags of phlash_tpu's
command line plus --device, psmcfa and VCF inputs (one --region per VCF
input) to a posterior that both packages' load_posterior read, the default
device, and the module entry point."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import phlash_tpu.__main__ as jmain
from phlash_tpu.results import load_posterior as jax_load_posterior
from phlash_tpu_torch.__main__ import _add_fit, main
from phlash_tpu_torch.results import load_posterior

ROOT = Path(__file__).resolve().parent.parent
HEADER = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    "A one-contig .psmcfa and a 4-sample VCF of 600 kb, from a numpy seed."
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    seq = "".join(rng.choice(list("TTTTTTTK"), size=1500))
    (tmp / "in.psmcfa").write_text(f">chr1\n{seq}\n")
    samples = ["sA", "sB", "sC", "sD"]
    lines = [HEADER + "\t".join(samples)]
    for p in np.sort(rng.choice(np.arange(1, 600_000), 3000, replace=False)):
        code = rng.choice(3, 4, p=[0.5, 0.3, 0.2])
        lines.append(f"chr1\t{p}\t.\tA\tT\t.\tPASS\t.\tGT\t"
                     + "\t".join(("0|0", "0|1", "1|1")[k] for k in code))
    (tmp / "in.vcf").write_text("\n".join(lines) + "\n")
    return tmp, samples


def _flags(add_fit) -> set[str]:
    ap = argparse.ArgumentParser()
    p = add_fit(ap.add_subparsers())
    return {s for a in p._actions for s in a.option_strings}


def test_flags_are_jax_cli_flags_plus_device():
    assert _flags(_add_fit) == _flags(jmain._add_fit) | {"--device"}


@pytest.mark.parametrize("kind", ["psmcfa", "vcf"])
def test_cli_fit_cpu(inputs, kind, tmp_path):
    """A few iterations on the CPU write a posterior of --particles models
    that both packages read (and, from the psmcfa, a plot); the VCF input is
    one file named twice, with one --region each, the first held out."""
    tmp, samples = inputs
    out = tmp_path / "post.npz"
    if kind == "psmcfa":
        pytest.importorskip("matplotlib")
        args = [str(tmp / "in.psmcfa"), "--plot", str(tmp_path / "post.png")]
    else:
        vcf = str(tmp / "in.vcf")
        args = [vcf, vcf, "--region", "chr1:300001-600000", "--region", "chr1:1-300000",
                "--samples", *samples, "--hold-out"]
    rc = main(["fit", *args, "--niter", "2", "--particles", "4", "--device", "cpu",
               "--out", str(out), "--seed", "3"])
    assert rc == 0 and (kind == "vcf" or (tmp_path / "post.png").stat().st_size > 0)
    ours, theirs = load_posterior(str(out)), jax_load_posterior(str(out))
    assert len(ours) == len(theirs) == 4
    for m in ours:
        assert torch.isfinite(m.eta.c).all() and (m.eta.c > 0).all() and np.isfinite(m.rho)


def test_cli_vcf_needs_a_region_each(inputs, tmp_path):
    tmp, samples = inputs
    vcf = str(tmp / "in.vcf")
    with pytest.raises(SystemExit, match="--region required"):
        main(["fit", vcf, vcf, "--region", "chr1:1-30000", "--samples", *samples,
              "--device", "cpu", "--out", str(tmp_path / "p.npz")])


def test_cli_default_device_is_the_card(inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    tmp, _ = inputs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["fit", str(tmp / "in.psmcfa"), "--niter", "1", "--out", str(tmp_path / "p.npz")])


def test_module_entry_point():
    """`python -m phlash_tpu_torch fit --help` and `bench --help` list
    --device; `bench` on a host without a card exits non-zero, refused."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                       os.environ.get("PYTHONPATH", "")]))
    run = [sys.executable, "-m", "phlash_tpu_torch"]
    for cmd in ("fit", "bench"):
        ok = subprocess.run(run + [cmd, "--help"], cwd=ROOT, env=env, capture_output=True,
                            text=True, timeout=120)
        assert ok.returncode == 0 and "--device" in ok.stdout, ok.stderr
    if torch.cuda.is_available():
        return
    bench = subprocess.run(run + ["bench"], cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=120)
    assert bench.returncode != 0 and "no CUDA device" in bench.stderr, bench.stderr
    assert bench.stdout == ""
