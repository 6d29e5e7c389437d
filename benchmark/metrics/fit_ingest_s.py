"""fit_ingest_s (s, layer: data): host seconds of the program's
phlash.start.ingest span (data.init_mcmc_data: reading and chunking the
contigs, in fit's spawn pool with files) inside the window's own fit
(phlash_tpu_torch.profiling.last_fit()).  None where the program records
no such span.  Moves setup_s (set-up runs fit once: the warm fit)."""


def read(run):
    from phlash_tpu_torch import profiling

    last = getattr(profiling, "last_fit", None)
    fit = last() if last is not None else None
    if fit is None or not fit.named("phlash.start.ingest"):
        return None
    return fit.total("phlash.start.ingest")
