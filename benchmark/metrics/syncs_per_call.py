"""syncs_per_call (count, layer: fit): the program's host_syncs counter a
call (the loop's blocking reads of the device: the finiteness check, the
ELPD read, the read-back's copy), averaged over the window's calls whose
phlash.call span closed whole while the profiler recorded
(phlash_tpu_torch.profiling.last_fit(), the window's fit).  None where the
program records no such span.  Moves iters_per_s."""


def read(run):
    from phlash_tpu_torch import profiling

    last = getattr(profiling, "last_fit", None)
    fit = last() if last is not None else None
    return fit.count_per_call("host_syncs") if fit is not None else None
