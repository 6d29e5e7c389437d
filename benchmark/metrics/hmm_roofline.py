"""hmm_roofline (%, layer: kernels B1-B3): the least time of B1-B3's work in the
traced calls (benchmark/counts.hmm_bound_s: the frozen counts at the
cell's shapes against 67 TFLOP/s and 3.35 TB/s) over their device time.
Moves iters_per_s."""

from benchmark import counts
from benchmark.tracing import HMM_KERNELS


def read(run):
    tr = run.trace
    if tr is None or not tr.iters:
        return None
    s = tr.seconds_of(HMM_KERNELS)
    return 100.0 * counts.hmm_bound_s(run.shapes, tr.iters, tr.calls) / s if s > 0 else None
