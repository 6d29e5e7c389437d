"""launch_ms_per_call (ms, layer: step): host milliseconds a call of the
program's phlash.call.launch span (training.Caller: the static-buffer
copies and the graph's replay), averaged over the window's calls whose
phlash.call span closed whole while the profiler recorded
(phlash_tpu_torch.profiling.last_fit(), the window's fit).  None where the
program records no such span.  Moves iters_per_s."""


def read(run):
    from phlash_tpu_torch import profiling

    last = getattr(profiling, "last_fit", None)
    fit = last() if last is not None else None
    s = fit.per_call("phlash.call.launch") if fit is not None else None
    return None if s is None else 1e3 * s
