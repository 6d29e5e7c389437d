"""Structured SMC' forward and adjoint: plain PyTorch versions and CUDA kernels.

Port of phlash_tpu/ops/pallas_smc.py.  Each (particle p, chunk s) pair is one
HMM instance.  Per site the forward computes the O(M) form of alpha @ A,

    v = b * S(alpha) + d * alpha + vv * P(u * alpha)

(S, P: strict suffix / prefix sums over the M states), applies the
emission factor (emis0 for hom, emis1 for het, 1 for missing; padding, -2 or
past the row's end, freezes the state), and every NORM_EVERY sites
rescales: c = max(sum alpha, TINY_NORM), alpha /= c, ll += log c.  The
adjoint rebuilds each period from its boundary state and sweeps it in
reverse (csrc/smc_backward.cu spells out the recursion).

Shapes, shared by both versions:
    params  6 tensors (B, M): b, d, u, vv, emis0, emis1 (per particle)
    pi      (B, S, M)         initial state per instance
    obs     (S, L) int8       the minibatch's observation rows
    ll      (B, S); alpha (B, S, M); pstates (n_per, S, B, M) with
    n_per = ceil(L / NORM_EVERY): the state at the start of every period,
    chunk-major so that the kernels' period stores and loads coalesce
    gradients: six (B, S, M) per instance (the caller sums over S) + dpi

Dispatch: `forward` / `backward` launch the CUDA kernels for CUDA tensors
(split as `segment_plan` says) and take the plain version for CPU tensors;
there is no other path and no fallback.  `forward_segmented` /
`backward_segmented` render the split in plain PyTorch for the tests and
the card's gates.  Every wrapper counts what it ran (`.launches` on the CUDA
wrappers, `.calls` on the plain versions; `forward_cuda.residual_launches`
the forward launches that kept residuals, B2); `reset_counts` zeroes them.
A wrapper counts when Python calls it, so a CUDA graph replay, which calls
no wrapper, adds what its capture counted through `add_counts`
(training.Caller does).

Kernel design note (csrc/smc_common.cuh, smc_forward.cu, smc_backward.cu).
* Replaces: B1/B2 = pallas_smc.forward_structured (with_residuals False /
  True, body _make_fwd_kernel) by one forward kernel whose residual store is
  switched by a null pointer; B3 = pallas_smc.backward_structured (body
  _make_bwd_kernel) by the adjoint kernel.
* What bounds it on the H100: neither bytes nor FLOPs but latency.  Per
  site each HMM runs a dependence chain (two scans over its M states, the
  emission, and every 8 sites a sum, a division and a log), and there are
  only B * S independent chains: 2500 at the fit shape (500 particles x 5
  chunks), 500 on one genome (S = 1, rows of ~94,000 sites).  One thread per
  chain would run the M states serially and fill 79 warps, 20 blocks of
  128: 20 of 132 SMs.
* What the design does about it:
  - states on lanes: a group of G = M / SPL lanes runs one instance, SPL
    states a lane, one SPL per M (`PHLASH_SMC_INSTANCES`, reported by
    `kernel_geometry`); at M = 16, SPL = 4 gives 4-lane groups, 8
    instances a warp, 315 one-warp blocks over all 132 SMs (it ran both
    kernels faster than SPL = 1, 16 lanes and 4x the warps);
  - scans by shuffles: S(x) and P(u x) are Kogge-Stone scans at width G
    (a local scan of the lane's SPL states, then log2 G shuffle steps),
    the two scans interleaved so their shuffles overlap; the suffix is a
    reverse scan, never total - prefix, which would lose the small states;
  - the normalizer (and the adjoint's <abar, a / c>) is an xor butterfly,
    so every lane of a group holds the same bits;
  - chunk-major blocks: a block holds 8 instances of one chunk, stages
    that chunk's observation row into shared memory (16-byte loads, 1024
    sites a tile, so any L works) and every lane reads its site's code as
    a broadcast; no lane skips a site (padding is a select), so the
    full-warp shuffles never sit in a divergent branch, and groups past the
    last particle compute on a clamped copy and store nothing;
  - the adjoint keeps each lane's 8-site cache (x, S(x), P(u x)) and its six
    gradient accumulators in registers, and loads the previous period's
    boundary state before the current period's work (a register double
    buffer), so that load's latency leaves the chain;
  - gradients are written per instance and summed over chunks in PyTorch:
    deterministic, no atomics.
* Segments along the row, where the instances leave the card nearly empty
  (`segment_plan`: K from the launch's warps, the SM count and L only, a
  target of warps for each direction; K = 1 runs the unsplit kernels
  above).  The chain forgets its start: two
  states run through the same sites meet, and once two normalized states
  at a period boundary hold the same bits every later site is the same
  computation.  So each row is cut into K segments of P periods (P a
  multiple of CHECK_PERIODS, so each rescales where the unsplit kernel
  does), and each direction runs three launches on grid (ceil(B / 8), S,
  K):
  - speculate: every segment from a guess (the forward from pi, segment 0
    exact; the adjoint from zero, the last segment from abar0, exact),
    storing its trajectory (the period states, abar every CHECK_PERIODS
    periods), each CHECK_PERIODS-period interval's sum (log c; the six
    gradient terms) and its end;
  - fix: segment k from its neighbour's speculative end, comparing with the
    stored trajectory at each checkpoint; at the first bitwise match it
    stops (the stored states from there on are its own), and before that
    its states and interval sums replace the speculative ones;
  - splice: a group an instance walks the segments in order from the exact
    one and re-runs, as the fix does, any segment whose stored trajectory
    did not start from its neighbour's true end (a neighbour that did not
    meet inside itself); what is stored stays one chain's trajectory, so a
    re-run may stop at any match.  A row that never forgets costs the
    unsplit time plus the two passes, and never gives another answer.
  pstates and alpha are bitwise the unsplit kernel's; ll and the gradients
  are the same terms summed by interval, segment and then row, in a fixed
  order (no float atomics).  The flags and sums live in per-call workspace;
  the four device counters (DEVICE_COUNTS) are integer atomics, zeroed and
  read by the fit's record (profiling.py), never by a call.
* No tensor cores: the transition is the O(M) structured form, not a
  matrix product; a 16-state vector is far below wgmma's 64-row tile; and
  TF32 or bf16 inputs would break the rtol 1e-5 ll gate (docs/DESIGN.md,
  "Why not the MXU": bf16 gave a 0.4% ll error on the TPU).
* The TPU layout (128-lane tiles, 2-bit observation codes in SMEM, the
  16-chunk split, the VMEM tile-block chooser) is not carried over.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from phlash_tpu_torch.ops.build import check, load_library, ptr, require_cuda, stream

NORM_EVERY = 8  # sites between rescalings (pallas_smc.NORM_EVERY)
TINY_NORM = 1e-30  # normalizer clamp (pallas_smc.TINY_NORM)
SUPPORTED_M = (8, 16, 32, 64)  # template instances of the CUDA kernels
# the kernels' mapping (csrc/smc_common.cuh's PHLASH_SMC_INSTANCES and
# INSTANCES_PER_BLOCK; the library reports both, a test reads the header)
STATES_PER_LANE = {8: 2, 16: 4, 32: 2, 64: 4}
INSTANCES_PER_BLOCK = 8
# the split path: periods between checkpoints (smc_common.cuh CHECK_EVERY),
# the warps a split launch aims for on each SM, by direction, and the
# shortest segment worth one more (set by the K sweeps, PERF.md §6): the
# forward's kernels hold 32 one-warp blocks an SM, the adjoint's 8 (255
# registers a thread), and a second wave of the adjoint only lengthens it
CHECK_PERIODS = 16
TARGET_WARPS_PER_SM = {"forward": 16, "adjoint": 8}
MIN_SEGMENT_SITES = 2048
# the split launches' device counters, in csrc's SplitCount order
DEVICE_COUNTS = ("smc_segments", "smc_segments_resolved", "smc_fix_sites", "smc_split_sites")


def n_periods(L: int) -> int:
    return -(-L // NORM_EVERY)


def launch_geometry(B: int, S: int, M: int, states_per_lane: int,
                    instances_per_block: int) -> dict:
    "How a mapping of M / states_per_lane lanes an instance lays B * S instances out."
    lanes = M // states_per_lane
    threads = instances_per_block * lanes
    blocks = -(-B // instances_per_block) * S
    return dict(states_per_lane=states_per_lane, lanes_per_instance=lanes,
                instances_per_warp=32 // lanes, threads_per_block=threads,
                blocks=blocks, warps=blocks * -(-threads // 32))


class Plan(NamedTuple):
    "K segments a row of P periods each (the last may have fewer); K = 1 is the unsplit kernel."

    K: int
    periods: int


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


def segment_plan(B: int, S: int, L: int, M: int, sms: int | None = None,
                 direction: str = "forward") -> Plan:
    """How the CUDA kernels of `direction` ("forward": B1 / B2, "adjoint":
    B3) split a launch's rows: K segments, where the unsplit grid's warps
    times K reach TARGET_WARPS_PER_SM[direction] on each of the device's
    `sms` SMs (the current CUDA device's when None), and no segment is
    shorter than MIN_SEGMENT_SITES sites.  K = 1 wherever the instances
    already fill the card or the rows are short."""
    if sms is None:
        sms = _sm_count(torch.cuda.current_device())
    warps = launch_geometry(B, S, M, STATES_PER_LANE[M], INSTANCES_PER_BLOCK)["warps"]
    return segments(n_periods(L), split_count(warps, TARGET_WARPS_PER_SM[direction], sms, L))


def split_count(warps: int, target: int, sms: int, L: int) -> int:
    """The rule of segment_plan (and of ops/packed.segment_plan) before
    `segments` rounds it: as many segments as bring an unsplit grid of
    `warps` warps to `target` warps on each of `sms` SMs, and no more than
    rows of L sites hold at MIN_SEGMENT_SITES a segment."""
    return min(target * sms // warps, L // MIN_SEGMENT_SITES)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernel_geometry(B: int, S: int, M: int) -> dict:
    """launch_geometry of the CUDA kernels at M, from the mapping the built
    library reports (csrc/smc_common.cuh owns it)."""
    _check_m(M)
    lib = load_library().lib
    return launch_geometry(B, S, M, lib.phlash_smc_states_per_lane(M),
                           lib.phlash_smc_instances_per_block())


def _suffix(x: torch.Tensor) -> torch.Tensor:
    "S(x)[j] = sum_{k > j} x[k] over the last axis."
    zero = torch.zeros_like(x[..., :1])
    return torch.cat([x[..., 1:].flip(-1).cumsum(-1).flip(-1), zero], -1)


def _prefix(x: torch.Tensor) -> torch.Tensor:
    "P(x)[j] = sum_{k < j} x[k] over the last axis."
    zero = torch.zeros_like(x[..., :1])
    return torch.cat([zero, x.cumsum(-1)[..., :-1]], -1)


def _site(obs: torch.Tensor, t: int) -> torch.Tensor:
    "(1, S, 1) codes of site t, to broadcast against (B, S, M)."
    return obs[:, t].view(1, -1, 1)


# ---------------------------------------------------------------------------
# plain PyTorch versions (any dtype, any device)
# ---------------------------------------------------------------------------


def _rows(params):
    "The six per-particle rows, broadcast against (B, S, M), and a ones row."
    b, d, u, vv, e0, e1 = (x[:, None, :] for x in params)
    return b, d, u, vv, e0, e1, torch.ones_like(e0)


def _forward_period(prm, a: torch.Tensor, obs: torch.Tensor, q: int):
    "Period q of the plain forward from the state a: (the rescaled state, c (B, S))."
    b, d, u, vv, e0, e1, one = prm
    for t in range(q * NORM_EVERY, min((q + 1) * NORM_EVERY, obs.shape[1])):
        ob = _site(obs, t)
        v = b * _suffix(a) + d * a + vv * _prefix(u * a)
        f = torch.where(ob == 0, e0, torch.where(ob == 1, e1, one))
        a = torch.where(ob == -2, a, v * f)
    c = torch.clamp_min(a.sum(-1, keepdim=True), TINY_NORM)
    return a / c, c[..., 0]


def _reverse_period(prm, a: torch.Tensor, obs: torch.Tensor, q: int, ab: torch.Tensor,
                    g: torch.Tensor, acc: tuple):
    """Period q of the plain adjoint: rebuild it from its start state a, sweep
    it in reverse from abar ab; (abar at its start, acc plus its six
    gradient terms)."""
    b, d, u, vv, e0, e1, one = prm
    db, dd, du, dvv, de0, de1 = acc
    zero = torch.zeros_like(ab)
    sites = []
    for t in range(q * NORM_EVERY, min((q + 1) * NORM_EVERY, obs.shape[1])):
        ob = _site(obs, t)
        f = torch.where(ob == 0, e0, torch.where(ob == 1, e1, one))
        sv, pv = _suffix(a), _prefix(u * a)
        v = b * sv + d * a + vv * pv
        sites.append((ob, f, a, sv, pv, v))
        a = torch.where(ob == -2, a, v * f)
    c = torch.clamp_min(a.sum(-1, keepdim=True), TINY_NORM)
    ybar = (ab - (ab * (a / c)).sum(-1, keepdim=True) + g) / c
    for ob, f, x, sv, pv, v in reversed(sites):
        live = ob != -2
        yb = torch.where(live, ybar, zero)
        dfull = v * yb
        de0 = de0 + torch.where(ob == 0, dfull, zero)
        de1 = de1 + torch.where(ob == 1, dfull, zero)
        vbar = f * yb
        db = db + sv * vbar
        dd = dd + x * vbar
        dvv = dvv + pv * vbar
        t1 = _suffix(vv * vbar)
        du = du + x * t1
        xbar = _prefix(b * vbar) + d * vbar + u * t1
        ybar = torch.where(live, xbar, ybar)
    return ybar, (db, dd, du, dvv, de0, de1)


def forward_structured(params, pi: torch.Tensor, obs: torch.Tensor, with_residuals: bool = True):
    "Plain forward: (ll (B, S), alpha (B, S, M), pstates (n_per, S, B, M) or None)."
    forward_structured.calls += 1
    prm = _rows(params)
    a = pi
    ll = torch.zeros(pi.shape[:2], dtype=pi.dtype, device=pi.device)
    pst = []
    for q in range(n_periods(obs.shape[1])):
        if with_residuals:
            pst.append(a)
        a, c = _forward_period(prm, a, obs, q)
        ll = ll + torch.log(c)
    pstates = torch.stack(pst).transpose(1, 2).contiguous() if with_residuals else None
    return ll, a, pstates


def backward_structured(params, obs: torch.Tensor, pstates: torch.Tensor, gbar: torch.Tensor,
                        abar0: torch.Tensor):
    """Plain adjoint: gbar (B, S) cotangent of ll, abar0 (B, S, M) cotangent
    of the final state.  Returns ((db, dd, du, dvv, de0, de1), dpi), each
    (B, S, M) per instance."""
    backward_structured.calls += 1
    prm = _rows(params)
    acc = (torch.zeros_like(abar0),) * 6
    ab = abar0
    g = gbar[..., None]
    for q in reversed(range(n_periods(obs.shape[1]))):
        ab, acc = _reverse_period(prm, pstates[q].transpose(0, 1), obs, q, ab, g, acc)
    return acc, ab


# ---------------------------------------------------------------------------
# the split path in plain PyTorch (csrc/smc_forward.cu, smc_backward.cu)
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


def forward_segmented(params, pi: torch.Tensor, obs: torch.Tensor, with_residuals: bool,
                      plan: Plan):
    """The split forward of the CUDA kernels (csrc/smc_forward.cu) in plain
    PyTorch, `plan.K` segments (fewer where the row has too few intervals):
    speculate, fix, splice, with the kernels' checkpoints and sums.  Returns
    forward_structured's (ll, alpha, pstates or None) and the four counts
    (DEVICE_COUNTS) the kernels add on the card.  pstates and alpha are
    forward_structured's bit for bit; ll is the same log c's summed by
    interval, segment and row."""
    L = obs.shape[1]
    n_per = n_periods(L)
    K, P = segments(n_per, plan.K)
    prm = _rows(params)
    false = torch.zeros(pi.shape[:2], dtype=torch.bool, device=pi.device)
    st = [None] * n_per  # the stored period states (the kernels keep the checkpoints' in B1)
    int_ll, seg_ll, spec_end, end = {}, [None] * K, [None] * K, [None] * K
    counts = dict.fromkeys(DEVICE_COUNTS, 0)

    def run(k: int, a: torch.Tensor, fix: bool):
        q0, q1 = k * P, min(k * P + P, n_per)
        done, met, wrote = false.clone(), false.clone(), false.clone()
        ran = torch.zeros(false.shape, dtype=torch.int64, device=false.device)
        acc = torch.zeros_like(false, dtype=pi.dtype)
        for q in range(q0, q1):
            if q % CHECK_PERIODS == 0:
                i = q // CHECK_PERIODS
                if q > q0:
                    int_ll[i - 1] = _keep(done, int_ll.get(i - 1), acc)
                    wrote |= ~done
                acc = torch.zeros_like(acc)
                if fix:
                    same = _same(a, st[q])
                    met |= same & ~done
                    done |= same
                    if bool(done.all()):
                        break
            st[q] = _keep(done, st[q], a)
            a, c = _forward_period(prm, a, obs, q)
            acc = acc + torch.log(c)
            ran += (~done) * (min((q + 1) * NORM_EVERY, L) - q * NORM_EVERY)
        else:
            i = (q1 - 1) // CHECK_PERIODS
            int_ll[i] = _keep(done, int_ll.get(i), acc)
            end[k] = _keep(done, end[k], a)
            wrote |= ~done
        total = torch.zeros_like(acc)
        for i in range(q0 // CHECK_PERIODS, (q1 - 1) // CHECK_PERIODS + 1):
            total = total + int_ll[i]
        seg_ll[k] = _keep(~wrote, seg_ll[k], total)
        return met, ran

    for k in range(K):
        _, ran = run(k, pi, False)
        spec_end[k] = end[k]
        counts["smc_split_sites"] += int(ran.sum())
    counts["smc_segments"] += K * false.numel()
    for k in range(1, K):
        met, ran = run(k, spec_end[k - 1], True)
        counts["smc_segments_resolved"] += int(met.sum())
        counts["smc_fix_sites"] += int(ran.sum())
    for k in range(1, K):
        _, ran = run(k, end[k - 1], True)
        counts["smc_fix_sites"] += int(ran.sum())
    ll = torch.zeros_like(seg_ll[0])
    for x in seg_ll:
        ll = ll + x
    pstates = torch.stack(st).transpose(1, 2).contiguous() if with_residuals else None
    return ll, end[K - 1], pstates, counts


def backward_segmented(params, obs: torch.Tensor, pstates: torch.Tensor, gbar: torch.Tensor,
                       abar0: torch.Tensor, plan: Plan):
    """The split adjoint of the CUDA kernels (csrc/smc_backward.cu) in plain
    PyTorch, as forward_segmented: speculative sweeps (the last segment from
    abar0, the others from zero), fix chains from each upper neighbour's
    speculative abar, the splice.  Returns backward_structured's
    ((db, dd, du, dvv, de0, de1), dpi), the same terms summed by interval,
    segment and row, and the four counts."""
    L = obs.shape[1]
    n_per = n_periods(L)
    K, P = segments(n_per, plan.K)
    prm = _rows(params)
    g = gbar[..., None]
    false = torch.zeros(gbar.shape, dtype=torch.bool, device=gbar.device)
    zeros = (torch.zeros_like(abar0),) * 6
    top, spec_end, seg_grad = [None] * K, [None] * K, [None] * K
    ab_ck, int_grad = {}, {}
    counts = dict.fromkeys(DEVICE_COUNTS, 0)

    def run(k: int, ab: torch.Tensor, fix: bool):
        q0, q1 = k * P, min(k * P + P, n_per)
        done, met, wrote = false.clone(), false.clone(), false.clone()
        ran = torch.zeros(false.shape, dtype=torch.int64, device=false.device)
        if fix:
            same = _same(ab, top[k])
            met |= same
            done |= same
            if bool(done.all()):
                return ab, met, ran
        top[k] = _keep(done, top[k], ab)
        acc = zeros
        for q in reversed(range(q0, q1)):
            ab, acc = _reverse_period(prm, pstates[q].transpose(0, 1), obs, q, ab, g, acc)
            ran += (~done) * (min((q + 1) * NORM_EVERY, L) - q * NORM_EVERY)
            if q % CHECK_PERIODS == 0:
                i = q // CHECK_PERIODS
                old = int_grad.get(i, (None,) * 6)
                int_grad[i] = tuple(_keep(done, o, x) for o, x in zip(old, acc))
                wrote |= ~done
                acc = zeros
                if fix:
                    same = _same(ab, ab_ck[i])
                    met |= same & ~done
                    done |= same
                    if bool(done.all()):
                        break
                ab_ck[i] = _keep(done, ab_ck.get(i), ab)
        total = zeros
        for i in range((q1 - 1) // CHECK_PERIODS, q0 // CHECK_PERIODS - 1, -1):
            total = tuple(t + x for t, x in zip(total, int_grad[i]))
        old = seg_grad[k] or (None,) * 6
        seg_grad[k] = tuple(_keep(~wrote, o, t) for o, t in zip(old, total))
        return ab, met, ran

    for k in range(K):
        spec_end[k], _, ran = run(k, abar0 if k == K - 1 else zeros[0], False)
        counts["smc_split_sites"] += int(ran.sum())
    counts["smc_segments"] += K * false.numel()
    for k in range(K - 1):
        _, met, ran = run(k, spec_end[k + 1], True)
        counts["smc_segments_resolved"] += int(met.sum())
        counts["smc_fix_sites"] += int(ran.sum())
    ab = ab_ck[(K - 1) * P // CHECK_PERIODS]
    for k in reversed(range(K - 1)):
        _, _, ran = run(k, ab, True)
        counts["smc_fix_sites"] += int(ran.sum())
        ab = ab_ck[k * P // CHECK_PERIODS]
    grads = zeros
    for x in seg_grad:
        grads = tuple(t + y for t, y in zip(grads, x))
    return grads, ab, counts


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _check_m(M: int) -> None:
    if M not in SUPPORTED_M:
        raise ValueError(f"the CUDA SMC kernels support M in {SUPPORTED_M}, got {M}")


def _check_shapes(params, obs, B: int, S: int, M: int, L: int) -> None:
    _check_m(M)
    if B * S == 0 or L == 0:
        raise ValueError(f"empty launch: B={B}, S={S}, L={L}")
    if any(tuple(p.shape) != (B, M) for p in params) or tuple(obs.shape) != (S, L):
        raise ValueError("parameter rows must be (B, M) and observations (S, L)")


def forward_cuda(params, pi: torch.Tensor, obs: torch.Tensor, with_residuals: bool = True):
    "The forward kernels (B1 without residuals, B2 with); shapes as the plain version."
    out = forward_launch(params, pi, obs, with_residuals)
    forward_cuda.launches += 1
    forward_cuda.residual_launches += with_residuals
    return out


def forward_launch(params, pi: torch.Tensor, obs: torch.Tensor, with_residuals: bool,
                   plan: Plan | None = None):
    """The forward kernels at `plan` (segment_plan's where None, as
    forward_cuda runs them; the card's gates also run K = 1 beside it).
    Counts no launch."""
    B, S, M = pi.shape
    L = obs.shape[1]
    dev = require_cuda([*params, pi], [obs])
    _check_shapes(params, obs, B, S, M, L)
    plan = plan or segment_plan(B, S, L, M, _sm_count(dev))
    lib = load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    ll = torch.empty(B, S, **f32)
    alpha = torch.empty(B, S, M, **f32)
    n_per = n_periods(L)
    pstates = torch.empty(n_per, S, B, M, **f32) if with_residuals else None
    K, P = segments(n_per, plan.K)
    with torch.cuda.device(dev):
        if K == 1:
            err = lib.lib.phlash_smc_forward(
                *map(ptr, params), ptr(pi), ptr(obs), B, S, L, M,
                ptr(ll), ptr(alpha), ptr(pstates), stream(dev),
            )
        else:
            n_chk = -(-n_per // CHECK_PERIODS)
            ckpt = None if with_residuals else torch.empty(n_chk, S, B, M, **f32)
            work = [torch.empty(n, S, B, **f32) for n in (n_chk, K)]  # interval, segment ll
            ends = [torch.empty(K, S, B, M, **f32) for _ in range(2)]  # speculative, stored
            err = lib.lib.phlash_smc_forward_split(
                *map(ptr, params), ptr(pi), ptr(obs), B, S, L, M, K, P,
                ptr(ll), ptr(alpha), ptr(pstates), ptr(ckpt), *map(ptr, work), *map(ptr, ends),
                ptr(_counters.on(dev)), stream(dev),
            )
    check(lib, err, "smc_forward launch")
    return ll, alpha, pstates


def backward_cuda(params, obs: torch.Tensor, pstates: torch.Tensor, gbar: torch.Tensor,
                  abar0: torch.Tensor):
    "The adjoint kernels (B3); shapes as the plain version."
    out = backward_launch(params, obs, pstates, gbar, abar0)
    backward_cuda.launches += 1
    return out


def backward_launch(params, obs: torch.Tensor, pstates: torch.Tensor, gbar: torch.Tensor,
                    abar0: torch.Tensor, plan: Plan | None = None):
    "The adjoint kernels at `plan` (as forward_launch).  Counts no launch."
    B, S, M = abar0.shape
    L = obs.shape[1]
    dev = require_cuda([*params, pstates, gbar, abar0], [obs])
    _check_shapes(params, obs, B, S, M, L)
    plan = plan or segment_plan(B, S, L, M, _sm_count(dev), "adjoint")
    n_per = n_periods(L)
    if tuple(pstates.shape) != (n_per, S, B, M) or tuple(gbar.shape) != (B, S):
        raise ValueError("pstates must be (n_per, S, B, M) and gbar (B, S)")
    if pstates.data_ptr() % 16:
        raise ValueError("pstates must start on a 16-byte boundary (the kernel reads it "
                         "by vector loads)")
    lib = load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    grads = [torch.empty(B, S, M, **f32) for _ in range(7)]
    K, P = segments(n_per, plan.K)
    with torch.cuda.device(dev):
        if K == 1:
            err = lib.lib.phlash_smc_backward(
                *map(ptr, params), ptr(obs), ptr(pstates), ptr(gbar), ptr(abar0),
                B, S, L, M, *map(ptr, grads), stream(dev),
            )
        else:
            n_chk = -(-n_per // CHECK_PERIODS)
            work = [torch.empty(K, S, B, M, **f32), torch.empty(n_chk, S, B, M, **f32),
                    torch.empty(K, S, B, M, **f32), torch.empty(n_chk, 6, S, B, M, **f32),
                    torch.empty(K, 6, S, B, M, **f32)]  # top, ab_ck, spec_end, int, seg
            err = lib.lib.phlash_smc_backward_split(
                *map(ptr, params), ptr(obs), ptr(pstates), ptr(gbar), ptr(abar0),
                B, S, L, M, K, P, *map(ptr, grads), *map(ptr, work),
                ptr(_counters.on(dev)), stream(dev),
            )
    check(lib, err, "smc_backward launch")
    return tuple(grads[:6]), grads[6]


# ---------------------------------------------------------------------------
# the split launches' device counters
# ---------------------------------------------------------------------------

class DeviceCounters:
    """The split launches' integer counters on each device, one int64 a name
    (`names`, in csrc's SplitCount order): made zeroed by the first split
    launch on a device, zeroed and read by the fit's record (profiling.py),
    never by a call."""

    def __init__(self, names: tuple):
        self.names, self.by_device = names, {}

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

    def read(self) -> dict:
        "The counts summed over the devices since the last reset (one sync where any exist)."
        out = dict.fromkeys(self.names, 0)
        for t in self.by_device.values():
            for name, n in zip(self.names, t.tolist()):
                out[name] += n
        return out


_counters = DeviceCounters(DEVICE_COUNTS)


def reset_device_counts() -> None:
    "Zero the split launches' device counters (a fit's record does at its start)."
    _counters.reset()


def device_counts() -> dict:
    """DEVICE_COUNTS summed over the devices since the last reset: the
    segments the split launches ran, those whose fix met inside their own
    segment, the sites the fix chains ran and the sites split.  Reads the
    device (one sync); zeros where nothing split."""
    return _counters.read()


# ---------------------------------------------------------------------------
# dispatch and counters
# ---------------------------------------------------------------------------


def forward(params, pi, obs, with_residuals: bool):
    "CUDA tensors launch the kernel, CPU tensors take the plain version."
    if obs.device.type == "cuda":
        return forward_cuda(params, pi, obs, with_residuals)
    if obs.device.type == "cpu":
        return forward_structured(params, pi, obs, with_residuals)
    raise ValueError(f"no SMC forward for device {obs.device}")


def backward(params, obs, pstates, gbar, abar0):
    "CUDA tensors launch the kernel, CPU tensors take the plain version."
    if obs.device.type == "cuda":
        return backward_cuda(params, obs, pstates, gbar, abar0)
    if obs.device.type == "cpu":
        return backward_structured(params, obs, pstates, gbar, abar0)
    raise ValueError(f"no SMC adjoint for device {obs.device}")


def reset_counts() -> None:
    forward_cuda.launches = forward_cuda.residual_launches = backward_cuda.launches = 0
    forward_structured.calls = backward_structured.calls = 0


def counts() -> dict:
    "forward_cuda counts B1 and B2 launches, forward_cuda_residuals B2's alone."
    return dict(
        forward_cuda=forward_cuda.launches, forward_cuda_residuals=forward_cuda.residual_launches,
        backward_cuda=backward_cuda.launches,
        forward_plain=forward_structured.calls, backward_plain=backward_structured.calls,
    )


def add_counts(n: dict) -> None:
    "Add `n`, a dict as counts() gives it, to the counters."
    forward_cuda.launches += n["forward_cuda"]
    forward_cuda.residual_launches += n["forward_cuda_residuals"]
    backward_cuda.launches += n["backward_cuda"]
    forward_structured.calls += n["forward_plain"]
    backward_structured.calls += n["backward_plain"]


reset_counts()
