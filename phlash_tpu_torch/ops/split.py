"""The row split of the HMM kernels: speculative segments with a bitwise splice.

Both kernel pairs, the SMC' forward and adjoint (B1-B3, ops/smc.py) and the
dense-transition pair (B4 / B5, ops/packed.py), run one chain of dependent
sites an instance.  Where the instances leave the card nearly empty (one
genome: a few hundred instances on rows of ~94,000 sites), each row is cut
into K segments of P periods, and each direction runs three launches:

- speculate: every segment from a guess (the forward from pi, segment 0
  exact; the adjoint from zero, the last segment from its true start),
  storing its trajectory (the period states, the carried state every
  CHECK_PERIODS periods), each CHECK_PERIODS-period interval's sums and its
  end;
- fix: segment k from its neighbour's speculative end, comparing with the
  stored trajectory at each checkpoint; at the first bitwise match it stops
  (the stored states from there on are its own), and before that its states
  and interval sums replace the speculative ones;
- splice: each instance walks the segments in order from the exact one and
  re-runs, as the fix does, any segment whose stored trajectory did not
  start from its neighbour's true end.

The chains forget their start: once two states at a checkpoint hold the
same bits, every later site is the same computation.  So the stored states
are bitwise the unsplit kernel's, and the sums are the same terms summed by
interval, segment and then row, in a fixed order.  A row that never forgets
costs the unsplit time plus the two passes, and never gives another answer.
A row may end before L (its live end, ops/smc.py): its last live segment
stops there and takes the adjoint's exact start, and the segments past it
are empty; plans stay those of whole rows.

This module holds what both pairs share: the rule that picks K
(`split_count`, `plan`: the launch's warps, the SM count and L only; K = 1
is the unsplit kernel), the plan's rounding to whole checkpoint intervals
(`segments`), the plain renderings of the protocol (`forward_segmented`,
`backward_segmented`, which the backends bind to their period steps and
which the CPU tests hold to the unsplit plain versions), and the split
launches' device counters (`DeviceCounters`).  The CUDA kernels
(csrc/smc_*.cu, csrc/packed_*.cu) implement the same protocol.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from phlash_tpu_torch import profiling

# periods between checkpoints (csrc's CHECK_EVERY), and the shortest segment
# worth one more (set by the K sweeps, PERF.md §6)
CHECK_PERIODS = 16
MIN_SEGMENT_SITES = 2048
# instances a block, shared by both kernel pairs (csrc/smc_common.cuh's
# INSTANCES_PER_BLOCK; the library reports it, a test reads the header)
INSTANCES_PER_BLOCK = 8


class Plan(NamedTuple):
    "K segments a row of P periods each (the last may have fewer); K = 1 is the unsplit kernel."

    K: int
    periods: int


def launch_geometry(B: int, S: int, M: int, states_per_lane: int,
                    instances_per_block: int) -> dict:
    "How a mapping of M / states_per_lane lanes an instance lays B * S instances out."
    lanes = M // states_per_lane
    threads = instances_per_block * lanes
    blocks = -(-B // instances_per_block) * S
    return dict(states_per_lane=states_per_lane, lanes_per_instance=lanes,
                instances_per_warp=32 // lanes, threads_per_block=threads,
                blocks=blocks, warps=blocks * -(-threads // 32))


def segments(n_per: int, K: int) -> Plan:
    """K segments of a row of n_per periods, each a whole number of
    CHECK_PERIODS-period intervals: fewer where the row has too few, and
    never an empty one."""
    if K <= 1:
        return Plan(1, n_per)
    P = -(-n_per // K)
    P = -(-P // CHECK_PERIODS) * CHECK_PERIODS
    K = -(-n_per // P)
    return Plan(K, P) if K > 1 else Plan(1, n_per)


def split_count(warps: int, target: int, sms: int, L: int) -> int:
    """The rule before `segments` rounds it: as many segments as bring an
    unsplit grid of `warps` warps to `target` warps on each of `sms` SMs,
    and no more than rows of L sites hold at MIN_SEGMENT_SITES a segment."""
    return min(target * sms // warps, L // MIN_SEGMENT_SITES)


def plan(warps: int, target: int, L: int, n_per: int, sms: int | None) -> Plan:
    """split_count's K for a launch of rows of L sites in n_per periods,
    rounded by `segments`; `sms` the current CUDA device's where None."""
    if sms is None:
        sms = sm_count(torch.cuda.current_device())
    return segments(n_per, split_count(warps, target, sms, L))


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# the protocol in plain PyTorch
# ---------------------------------------------------------------------------


def _same(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    "(B, S): whether x and y (B, S, M) hold the same bits in every state."
    bits = torch.int64 if x.element_size() == 8 else torch.int32
    return (x.view(bits) == y.view(bits)).all(-1)


def _keep(done: torch.Tensor, old, new):
    """new where an instance is not done, old where it is (new alone where
    nothing was stored); done (B, S) against (B, S, ...) values."""
    if old is None:
        return new
    return torch.where(done.view(*done.shape, *(1,) * (old.dim() - done.dim())), old, new)


def _ends(live, n_per: int, P: int, shape, device):
    """(n_live, k_last), (B, S) int64 each: the periods each instance's row
    runs (`live` (S,), its live end; every period where None) and its last
    live segment (-1 where it runs none)."""
    if live is None:
        n_live = torch.full(shape, n_per, dtype=torch.int64, device=device)
    else:
        n_live = live.to(device=device, dtype=torch.int64).view(1, -1).expand(shape)
    return n_live, torch.where(n_live > 0, (n_live - 1) // P, -1)


def _total(first: int, last: int, sums: dict, upto: torch.Tensor, zero: tuple):
    """The interval sums `sums[i]` (tuples of (B, S, ...) terms) added up from
    interval `first` to `last` in that order, each instance's only up to its
    interval `upto` (B, S)."""
    step = 1 if last >= first else -1
    total = zero
    for i in range(first, last + step, step):
        if i in sums:
            total = tuple(t + torch.where((i <= upto).view(*upto.shape, *(1,) * (x.dim() - 2)),
                                          x, 0)
                          for t, x in zip(total, sums[i]))
    return total


def forward_segmented(period: Callable, pi: torch.Tensor, L: int, sites: int, plan: Plan,
                      names: tuple, live: torch.Tensor | None = None):
    """The split forward of a row of L sites in periods of `sites` sites,
    `plan.K` segments (fewer where the row has too few intervals):
    speculate, fix, splice, with the kernels' checkpoints and sums.
    `period(state, q) -> (state after period q, the period's sum of log c
    (B, S))` is the backend's unsplit step; pi (B, S, M) the start; `live`
    (S,) each row's live periods (the kernels' live ends; whole rows where
    None): a row runs its periods below its end only, and a segment wholly
    past it is empty.  Returns (ll (B, S), the state at each row's end, the
    state at the start of every period (zero from a row's end on), and the
    four device counts under `names`, in csrc's SplitCount order).  The
    states are the unsplit chain's bit for bit; ll is the same sums by
    interval, segment and row."""
    n_per = -(-L // sites)
    K, P = segments(n_per, plan.K)
    false = torch.zeros(pi.shape[:2], dtype=torch.bool, device=pi.device)
    n_live, k_last = _ends(live, n_per, P, false.shape, pi.device)
    st = [None] * n_per  # the stored period states
    int_ll, seg_ll, spec_end, end = {}, [None] * K, [None] * K, [None] * K
    counts = dict.fromkeys(names, 0)
    n_seg, n_resolved, n_fix, n_split = names

    def run(k: int, a: torch.Tensor, fix: bool):
        q0, q_hi = k * P, min(k * P + P, n_per)
        q1 = n_live.clamp(max=q_hi)  # each instance's end of the segment (<= q0: empty)
        done, met, wrote = q1 <= q0, false.clone(), false.clone()
        ran = torch.zeros(false.shape, dtype=torch.int64, device=false.device)
        acc = torch.zeros_like(false, dtype=pi.dtype)
        for q in range(q0, q_hi):
            fin = (q1 == q) & ~done  # rows whose live end is here: their last interval, end
            if bool(fin.any()):
                i = (q - 1) // CHECK_PERIODS
                int_ll[i] = _keep(~fin, int_ll.get(i), acc)
                end[k] = _keep(~fin, end[k], a)
                wrote |= fin
                done = done | fin
            if bool(done.all()):
                break
            if q % CHECK_PERIODS == 0:
                i = q // CHECK_PERIODS
                if q > q0:
                    int_ll[i - 1] = _keep(done, int_ll.get(i - 1), acc)
                    wrote |= ~done
                acc = torch.zeros_like(acc)
                if fix:
                    same = _same(a, st[q])
                    met |= same & ~done
                    done = done | same
                    if bool(done.all()):
                        break
            st[q] = _keep(done, st[q], a)
            a, lc = period(a, q)
            acc = acc + lc
            ran += (~done) * (min((q + 1) * sites, L) - q * sites)
        else:
            i = (q_hi - 1) // CHECK_PERIODS
            int_ll[i] = _keep(done, int_ll.get(i), acc)
            end[k] = _keep(done, end[k], a)
            wrote |= ~done
        sums = {i: (x,) for i, x in int_ll.items()}
        total, = _total(q0 // CHECK_PERIODS, (q_hi - 1) // CHECK_PERIODS, sums,
                        (q1 - 1) // CHECK_PERIODS, (torch.zeros_like(acc),))
        seg_ll[k] = _keep(~wrote, seg_ll[k], total)
        return met, ran

    k_top = int(k_last.max())  # no row runs a segment past it
    for k in range(k_top + 1):
        _, ran = run(k, pi, False)
        spec_end[k] = end[k]
        counts[n_split] += int(ran.sum())
        counts[n_seg] += int((k <= k_last).sum())
    for k in range(1, k_top + 1):
        met, ran = run(k, spec_end[k - 1], True)
        counts[n_resolved] += int(met.sum())
        counts[n_fix] += int(ran.sum())
    for k in range(1, k_top + 1):
        _, ran = run(k, end[k - 1], True)
        counts[n_fix] += int(ran.sum())
    ll = torch.zeros_like(false, dtype=pi.dtype)
    alpha = pi
    for k in range(k_top + 1):
        ll = ll + seg_ll[k]
        alpha = _keep(k != k_last, alpha, end[k])
    zero = torch.zeros_like(pi)
    st = [zero if x is None else _keep(q >= n_live, zero, x) for q, x in enumerate(st)]
    return ll, alpha, st, counts


def backward_segmented(reverse: Callable, last: torch.Tensor, zeros: tuple, L: int, sites: int,
                       plan: Plan, names: tuple, live: torch.Tensor | None = None):
    """The split adjoint, as forward_segmented: speculative sweeps (each
    row's last live segment from `last`, its true start, the others from
    zero), fix sweeps from each upper neighbour's speculative abar, the
    splice; `live` as forward_segmented's (a row's sweep starts at its end).
    `reverse(abar, q, acc) -> (abar at period q's start, acc plus the
    period's gradient terms)` is the backend's unsplit step, `zeros` its
    zero terms.  Returns (the terms summed by interval, segment and row,
    abar at the row's start (`last` where the row runs no period), the four
    device counts under `names`)."""
    n_per = -(-L // sites)
    K, P = segments(n_per, plan.K)
    false = torch.zeros(last.shape[:2], dtype=torch.bool, device=last.device)
    n_live, k_last = _ends(live, n_per, P, false.shape, last.device)
    zero = torch.zeros_like(last)
    top, spec_end, seg_grad = [None] * K, [None] * K, [None] * K
    ab_ck, int_grad = {}, {}
    counts = dict.fromkeys(names, 0)
    n_seg, n_resolved, n_fix, n_split = names
    none = (None,) * len(zeros)

    def run(k: int, ab: torch.Tensor, fix: bool):
        q0, q_hi = k * P, min(k * P + P, n_per)
        q1 = n_live.clamp(max=q_hi)  # each instance's sweep starts at period q1 - 1
        # the fix and the splice re-run the segments below each row's last live one
        done = k >= k_last if fix else k > k_last
        met, wrote = false.clone(), false.clone()
        ran = torch.zeros(false.shape, dtype=torch.int64, device=false.device)
        if bool(done.all()):
            return ab, met, ran
        if fix:
            same = _same(ab, top[k])
            met |= same & ~done
            done = done | same
            if bool(done.all()):
                return ab, met, ran
        top[k] = _keep(done, top[k], ab)
        acc = zeros
        for q in reversed(range(q0, q_hi)):
            wait = q >= q1  # rows whose sweep starts below q
            ab_q, acc_q = reverse(ab, q, acc)
            ab = _keep(wait, ab, ab_q)
            acc = tuple(_keep(wait, o, x) for o, x in zip(acc, acc_q))
            ran += (~done & ~wait) * (min((q + 1) * sites, L) - q * sites)
            if q % CHECK_PERIODS == 0:
                i = q // CHECK_PERIODS
                old = int_grad.get(i, none)
                int_grad[i] = tuple(_keep(done | wait, o, x) for o, x in zip(old, acc))
                wrote |= ~done & ~wait
                acc = zeros
                if fix:
                    same = _same(ab, ab_ck[i])
                    met |= same & ~done
                    done = done | same
                    if bool(done.all()):
                        break
                ab_ck[i] = _keep(done | wait, ab_ck.get(i), ab)
        total = _total((q_hi - 1) // CHECK_PERIODS, q0 // CHECK_PERIODS, int_grad,
                       (q1 - 1) // CHECK_PERIODS, zeros)
        old = seg_grad[k] or none
        seg_grad[k] = tuple(_keep(~wrote, o, t) for o, t in zip(old, total))
        return ab, met, ran

    k_top = int(k_last.max())  # no row runs a segment past it
    for k in range(k_top + 1):
        spec_end[k], _, ran = run(k, _keep(k == k_last, last, zero), False)
        counts[n_split] += int(ran.sum())
        counts[n_seg] += int((k <= k_last).sum())
    for k in range(k_top):
        _, met, ran = run(k, spec_end[k + 1], True)
        counts[n_resolved] += int(met.sum())
        counts[n_fix] += int(ran.sum())
    ab = last  # each row's splice starts from its last live segment's start
    for k in range(k_top + 1):
        if bool((k == k_last).any()):
            ab = _keep(k != k_last, ab, ab_ck[k * P // CHECK_PERIODS])
    for k in reversed(range(k_top)):
        _, _, ran = run(k, ab, True)
        counts[n_fix] += int(ran.sum())
        ab = _keep(k >= k_last, ab, ab_ck[k * P // CHECK_PERIODS])
    grads = zeros
    for x in seg_grad:
        if x is not None:
            grads = tuple(t + y for t, y in zip(grads, x))
    return grads, ab, counts


# ---------------------------------------------------------------------------
# the split launches' device counters
# ---------------------------------------------------------------------------


class DeviceCounters:
    """The split launches' integer counters on each device, one int64 a name
    (`names`, in csrc's SplitCount order): made zeroed by the first split
    launch on a device.  Each set belongs to the fit's record
    (profiling.py), which zeroes it when a fit opens and reads it when the
    fit closes; no call reads it."""

    def __init__(self, names: tuple):
        self.names, self.by_device = names, {}
        profiling.in_fit_record(self)

    def on(self, dev: torch.device) -> torch.Tensor:
        "The device's counters, made (zeroed) at the first split launch on it."
        t = self.by_device.get(dev)
        if t is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the split kernels' device counters are made by an eager "
                                   "launch; run the call once before capturing it")
            t = self.by_device[dev] = torch.zeros(len(self.names), dtype=torch.int64, device=dev)
        return t

    def reset(self) -> None:
        for t in self.by_device.values():
            t.zero_()

    def counts(self) -> dict:
        """The counts summed over the devices since the last reset: the
        segments the split launches ran, those whose fix met inside their
        own segment, the sites the fix chains ran and the sites split.
        Reads the device (one sync) where a split launch ran; zeros where
        nothing split."""
        out = dict.fromkeys(self.names, 0)
        for t in self.by_device.values():
            for name, n in zip(self.names, t.tolist()):
                out[name] += n
        return out
