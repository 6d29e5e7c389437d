"""packed_fix_share (%, layer: kernels B4-B5): of the sites the dense-transition
kernels' split launches ran along their rows, the share that the fix chains
ran again (100 * packed_fix_sites / max(packed_split_sites, 1), the device
counts of phlash_tpu_torch.profiling.last_fit(), the window's fit).  0 where
no launch split; None where the fit's record holds no such counts.  Moves
iters_per_s."""


def read(run):
    from phlash_tpu_torch import profiling

    last = getattr(profiling, "last_fit", None)
    fit = last() if last is not None else None
    counts = getattr(fit, "counts", None) or {}
    if "packed_fix_sites" not in counts or "packed_split_sites" not in counts:
        return None
    return 100.0 * counts["packed_fix_sites"] / max(counts["packed_split_sites"], 1)
