"""step_mfu (%, layer: step): the counted float32 operations of the traced
calls (benchmark/counts: every iteration's B2 + B3, A1 + A2 and S1-S3,
every call's ELPD) over the traced window's seconds times 67 TFLOP/s.  It
counts the algorithm's work from shapes, whatever kernels run it.  Moves
iters_per_s."""

from benchmark import counts
from benchmark.frozen.roofline import PEAK_FP32


def read(run):
    tr = run.trace
    if tr is None or not tr.iters or tr.busy_s <= 0:
        return None
    sh = run.shapes
    ops = tr.iters * counts.iteration_flops(sh) + tr.calls * counts.elpd_flops(sh)
    return 100.0 * ops / (tr.window_s * PEAK_FP32)
