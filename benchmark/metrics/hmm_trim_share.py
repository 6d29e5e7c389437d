"""hmm_trim_share (%, layer: kernels B1-B3): of the instance-sites of the
rows the SMC' likelihood launches received, the share past the rows' live
ends, which the kernels no longer run (100 * smc_trimmed_sites /
max(smc_row_sites, 1), the device counts of
phlash_tpu_torch.profiling.last_fit(), the window's fit).  0 where no launch
trimmed; None where the fit's record holds no such counts.  Moves iters_per_s."""


def read(run):
    from phlash_tpu_torch import profiling

    last = getattr(profiling, "last_fit", None)
    fit = last() if last is not None else None
    counts = getattr(fit, "counts", None) or {}
    if "smc_trimmed_sites" not in counts or "smc_row_sites" not in counts:
        return None
    return 100.0 * counts["smc_trimmed_sites"] / max(counts["smc_row_sites"], 1)
