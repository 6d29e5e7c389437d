"""ckpt_ms_per_save (ms, layer: fit): host milliseconds of the program's
phlash.call.checkpoint spans (a save's hand-off on the fit's thread: the
state's gather on a mesh, the join of the write before, the snapshot)
over the saves counted in the same calls (the writer's counter
ckpt_saves), in the window's calls whose phlash.call span closed whole
while the profiler recorded (phlash_tpu_torch.profiling.last_fit(), the
window's fit).  None where the program counts no save in them.  Moves
iters_per_s."""


def read(run):
    from phlash_tpu_torch import profiling

    last = getattr(profiling, "last_fit", None)
    fit = last() if last is not None else None
    saves = fit.count_per_call("ckpt_saves") if fit is not None else None
    if not saves:
        return None
    return 1e3 * fit.per_call("phlash.call.checkpoint") / saves
