"""The frozen copies equal the program's yardsticks at the commit they were copied from.

These tests read the program's roofline.py and the tool's synthesis, which
later PRs may change: a failure here says the copy and the program have
parted, and that the benchmark keeps measuring against the copy."""

import gzip
import importlib.util

import pytest
from conftest import ROOT

from benchmark import counts
from benchmark.frozen import genome
from benchmark.frozen import roofline as frozen
from phlash_tpu_torch import roofline as program

# (M, B, S, L) of B1-B3 in the three cells: the warm-up filter, the body, the ELPD
SHAPES = [(16, 500, 1, 500), (16, 500, 1, 93999), (16, 500, 4, 500), (16, 500, 4, 93999),
          (16, 500, 5, 500), (16, 500, 5, 94000), (16, 500, 5, 100), (16, 500, 5, 500)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", ["smc_forward", "smc_forward_residuals", "smc_backward"])
def test_smc_counts(kernel, shape):
    assert frozen.kernel_bound(kernel, *shape) == program.kernel_bound(kernel, *shape)
    assert frozen.kernel_bytes(kernel, *shape) == program.kernel_bytes(kernel, *shape)


@pytest.mark.parametrize("name", ["smc_forward", "smc_backward"])
def test_flops_per_site(name):
    assert frozen.flops_per_site(name, 16) == program.flops_per_site(name, 16)


@pytest.mark.parametrize("nm1, R", [(1, 1), (39, 11), (0, 0)])
@pytest.mark.parametrize("name", ["assembly_forward", "assembly_backward"])
def test_assembly_counts(name, nm1, R):
    assert frozen.assembly_bound(name, 500, 16, 18, nm1, R) == program.assembly_bound(
        name, 500, 16, 18, nm1, R)
    assert frozen.assembly_flops(16, 18, nm1, R) == program.assembly_flops(16, 18, nm1, R)


@pytest.mark.parametrize("name", program.SVGD_KERNELS)
def test_svgd_counts(name):
    assert frozen.svgd_bound(name, 500, 18) == program.svgd_bound(name, 500, 18)


def test_peaks():
    assert (frozen.PEAK_FP32, frozen.PEAK_FP64, frozen.PEAK_BYTES) == (
        program.PEAK_FP32, program.PEAK_FP64, program.PEAK_BYTES)
    assert frozen.GRAD_PASSES == program.GRAD_PASSES


def test_svgd_flops_are_the_bound_counts():
    "counts.svgd_flops sums the operations svgd_bound holds S1-S3 to (S3 is operation-bound)."
    P, D = 500, 18
    m = P * (P - 1) // 2
    s1s2 = 3 * D * m + m
    s3 = counts.svgd_flops(P, D) - s1s2
    assert frozen.svgd_bound("svgd_update", P, D) == frozen.bound(
        s3, 4 * (3 * P * D + 1 + 3 * P * D + 4 * P * D) + 16)


def test_vcf_synthesis_is_the_tools(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "torch_genome_scale_demo", ROOT / "tools" / "torch_genome_scale_demo.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    (tmp_path / "tool").mkdir()
    (tmp_path / "copy").mkdir()
    theirs = tool.synthesize(str(tmp_path / "tool"), 0.0005, 99)
    ours = genome.synthesize(str(tmp_path / "copy"), 0.0005, 99)
    assert genome.CHROM_MB == tool.CHROM_MB and genome.SAMPLE == tool.SAMPLE
    for (p1, c1, l1), (p2, c2, l2, _, _) in zip(theirs, ours, strict=True):
        assert (c1, l1) == (c2, l2)
        assert gzip.open(p1).read() == gzip.open(p2).read()
