"""hmm_ms_per_iter (ms, layer: kernels B1-B3): device time of the SMC' kernels B1-B3
(smc_forward_kernel, smc_backward_kernel) in the traced calls, over their
iterations (the ELPD's B1 included).  Moves iters_per_s."""

from benchmark.tracing import HMM_KERNELS


def read(run):
    tr = run.trace
    if tr is None or not tr.iters:
        return None
    s = tr.seconds_of(HMM_KERNELS)
    return s / tr.iters * 1e3 if s > 0 else None
