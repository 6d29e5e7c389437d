"""capture_s (s, layer: step): host seconds of the program's
phlash.capture spans, summed (each CUDA graph's warm-up, capture and
instantiation; none on the CPU) in the window's fit
(phlash_tpu_torch.profiling.last_fit()).  None where the program records
no fit.  Moves setup_s."""


def read(run):
    from phlash_tpu_torch import profiling

    last = getattr(profiling, "last_fit", None)
    fit = last() if last is not None else None
    return None if fit is None else fit.total("phlash.capture")
