"""hmm_fix_share (%, layer: kernels B1-B3): of the sites the SMC' kernels'
split launches ran along their rows, the share that the fix chains ran
again (100 * smc_fix_sites / max(smc_split_sites, 1), the device counts of
phlash_tpu_torch.profiling.last_fit(), the window's fit).  0 where no launch
split; None where the fit's record holds no such counts.  Moves iters_per_s."""


def read(run):
    from phlash_tpu_torch import profiling

    last = getattr(profiling, "last_fit", None)
    fit = last() if last is not None else None
    counts = getattr(fit, "counts", None) or {}
    if "smc_fix_sites" not in counts or "smc_split_sites" not in counts:
        return None
    return 100.0 * counts["smc_fix_sites"] / max(counts["smc_split_sites"], 1)
