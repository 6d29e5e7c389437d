"""collectives_per_call (count, layer: mesh): the program's counter
collectives a call (every collective of a mesh's fit, those a CUDA graph's
replay runs included: parallel/mesh.py's tally), averaged over the
window's calls whose phlash.call span closed whole while the profiler
recorded (phlash_tpu_torch.profiling.last_fit(), the window's fit).  None
where no such call counted one (a fit without a mesh).  Moves iters_per_s."""


def read(run):
    from phlash_tpu_torch import profiling

    last = getattr(profiling, "last_fit", None)
    fit = last() if last is not None else None
    if fit is None or not any("collectives" in c.counts for c in fit.calls()):
        return None
    return fit.count_per_call("collectives")
