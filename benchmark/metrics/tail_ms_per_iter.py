"""tail_ms_per_iter (ms, layer: model and update): device time of every device op
in the traced calls that is not B1-B3 (the assembly A1 / A2, the update
S1-S3, ATen's glue kernels, copies and fills), over their iterations.
Moves iters_per_s."""

from benchmark.tracing import HMM_KERNELS


def read(run):
    tr = run.trace
    if tr is None or not tr.iters or not tr.device_s:
        return None
    return (sum(tr.device_s.values()) - tr.seconds_of(HMM_KERNELS)) / tr.iters * 1e3
