"""ckpt_write_ms_per_save (ms, layer: checkpoint): host milliseconds of the
program's phlash.checkpoint.write spans (each write on the checkpoint
writer's thread: the wait for the snapshot's copies, the file's write and
its atomic replace), summed over the window's fit, over the saves its
record counts (ckpt_saves; phlash_tpu_torch.profiling.last_fit()).  The
writes overlap the fit's calls; a save that finds the write before still
running waits for it (ckpt_waits).  None where the record counts no save.
Moves iters_per_s."""


def read(run):
    from phlash_tpu_torch import profiling

    last = getattr(profiling, "last_fit", None)
    fit = last() if last is not None else None
    saves = (getattr(fit, "counts", None) or {}).get("ckpt_saves")
    if not saves:
        return None
    return 1e3 * fit.total("phlash.checkpoint.write") / saves
