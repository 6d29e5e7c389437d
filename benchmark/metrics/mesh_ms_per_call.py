"""mesh_ms_per_call (ms, layer: mesh): host milliseconds a call of the
program's phlash.mesh.collective spans (each collective issued on the host
outside a CUDA graph's capture: the read-back's and the checkpoint's
gathers, the finiteness check's all-reduce; on NCCL the host's share, its
enqueue), averaged over the window's calls whose phlash.call span closed
whole while the profiler recorded (phlash_tpu_torch.profiling.last_fit(),
the window's fit).  None where the program records no such span.  Moves
iters_per_s."""


def read(run):
    from phlash_tpu_torch import profiling

    last = getattr(profiling, "last_fit", None)
    fit = last() if last is not None else None
    if fit is None or not fit.named("phlash.mesh.collective"):
        return None
    s = fit.per_call("phlash.mesh.collective")
    return None if s is None else 1e3 * s
