"""upload_s (s, layer: data): host seconds of the program's
phlash.start.upload spans, summed (the copies of the training and held-out
chunk rows and warm-ups to the device) in the window's fit
(phlash_tpu_torch.profiling.last_fit()).  None where the program records
no such span.  Moves setup_s."""


def read(run):
    from phlash_tpu_torch import profiling

    last = getattr(profiling, "last_fit", None)
    fit = last() if last is not None else None
    if fit is None or not fit.named("phlash.start.upload"):
        return None
    return fit.total("phlash.start.upload")
