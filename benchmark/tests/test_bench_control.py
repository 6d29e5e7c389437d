"""The control fails each cell's check: the reference in bfloat16, or in TF32, in the program's place.

The cells state float32, the CUDA kernels' only dtype (they use no tensor
cores, so no TF32 mode is there to switch off); the control is the
reference put in the program's place and computed in the precision below:
bfloat16 (float32 with every product's operands rounded to a 7-bit
mantissa), and TF32's 10 bits besides.  Its outputs go through the cell's
own check (benchmark/check.judge with the cell's limits): the cloud after
the call, from the reference's step in that precision, and the held-out
ELPD at that cloud in that precision.  It is elpd_gap that fails:
density_gap reads a precision step no higher than float32's rounding.  On
the card, at the cells' own sizes, benchmark/readings.py --variants bf16
tf32 reads the same through the run's path: bfloat16 fails every cell on
every seed read, TF32 most (PERF.md gives the readings).  Here it runs on
the CPU with the genome at 2% of its length, so that the ELPD's rows hold
a few thousand sites, and one step of the reference."""

import pytest
from conftest import tiny_cell

from benchmark import check, inputs, shapes
from benchmark.readings import variant
from benchmark.reference import fit as reference


@pytest.mark.parametrize("arith", ["bf16", "tf32"])
@pytest.mark.parametrize("workload", ["diploid.genome", "cohort.genome", "diploid.short_chunks"])
def test_tf32_control_fails_the_limit(workload, arith):
    cell = tiny_cell(workload, particles=8)
    cell.config["data"]["scale"] = 0.02
    if cell.config["data"]["input"] == "matrix":
        cell.config["data"]["samples"] = 2
    data = inputs.make(cell.config, 7)
    try:
        opts = cell.fit_options()
        sh = shapes.resolve(data.ref, data.ref_test, opts, cell.traffic)
        opts["minibatch_size"] = sh.S
        pb = reference.prepare(data.ref, opts, 7, "cpu", k=1, ref_test=data.ref_test)
    finally:
        data.close()
    ref = check.Reference(pb, reference, tuple(cell.limits))
    got = ref.numbers_of(variant(ref, None, arith))
    correct, checks = check.judge(got, cell.limits, 0)
    assert not correct and checks["elpd_gap"]["value"] > checks["elpd_gap"]["limit"], checks
