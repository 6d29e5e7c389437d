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

Each row's live end (`live`, (S,) int32 from `live_periods`, or None for
whole rows): the periods up to and including the one that holds the row's
last observed site (code 0 or 1), 0 where it has none.  Given it, every
version runs each row up to its end only: the forward sums log c over
those periods and stores their states (its alpha is the state there, not
at the row's end), the adjoint starts at the last live period from abar0.
Past the row's last observed site every emission factor is 1 and the
structured transition is row-stochastic, so the tail's rescalings sum to
log 1 = 0: nothing of ll, and no gradient with respect to the model's
parameters (the six per-particle rows' own gradients lose the tail's
terms, which lie across the row-sum constraint, so the assembly's
Jacobian maps them to zero), and the abar the tail hands back is a
multiple of ones, which the last live period's rescale takes out.  What
the tail computed was the rounding of its rescalings and of the
transition's row sums.  The end is rounded
up to a whole period, so every state and c before it keeps the whole row's
bits.  Only the fit's density trims (kernel_smc's `model_loglik_rows`: the
step's likelihood and the held-out ELPD), whose parameters come from
demographic models and whose final state nobody reads.  The phlash_tpu
entries take any PSMCParams, whose rows need not sum to 1, and keep whole
rows; so does the warm-up filter, which reads its final state (a missing
run at the end of its prefix moves it).

Dispatch: `forward` / `backward` launch the CUDA kernels for CUDA tensors
(split as `segment_plan` says) and take the plain version for CPU tensors;
there is no other path and no fallback.  `forward_segmented` /
`backward_segmented` render the split (ops/split.py) in plain PyTorch for
the tests and the card's gates.  Every wrapper counts what it ran in
`tally` (`counts`, `reset_counts`, `add_counts`; forward_cuda_residuals
the forward launches that kept residuals, B2).  A wrapper counts when
Python calls it, so a CUDA graph replay, which calls no wrapper, adds what
its capture counted (training.Caller, through profiling's registry).

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
    buffer), so that load's latency leaves the chain; its split kernels
    keep the cache in shared memory instead (a slice a warp, each site's
    read after its scan, off the abar chain), so that they fit in 128
    registers and hold as many warps an SM as the forward's
    (`resident_warps` reports what the built kernel holds; the plan never
    asks for more), except where a split launch puts no more warps on the
    card than kernels with the cache in registers hold, whose chains are
    faster one warp at a time (`shared_cache`; B3 on an H100 at B = 32,
    S = 1, L = 5,000, K = 2: 1.04 against 1.19 ms; at B = 500, S = 1,
    L = 94,000, K = 16: 2.45 against 2.72);
  - gradients are written per instance and summed over chunks in PyTorch:
    deterministic, no atomics.
* Segments along the row, where the instances leave the card nearly empty
  (ops/split.py: speculate, fix, splice; `segment_plan` takes K from the
  launch's warps, the SM count and L only, with a target of warps for
  each direction, the adjoint's capped by what its kernel holds on the
  card; K = 1 runs the unsplit kernels above).  Each row is cut
  into K segments of P periods (P a multiple of CHECK_PERIODS, so each
  rescales where the unsplit kernel does), and each direction runs three
  launches on grid (ceil(B / 8), S, K).  The forward's guess is pi, its
  stored trajectory the period states; the adjoint's guess is zero (the
  last segment's is abar0, exact), its trajectory abar every
  CHECK_PERIODS periods.  pstates and alpha are bitwise the unsplit
  kernel's; ll and the gradients are the same terms summed by interval,
  segment and then row, in a fixed order (no float atomics).  The flags
  and sums live in per-call workspace; the four device counters
  (DEVICE_COUNTS) are integer atomics, zeroed and read by the fit's record
  (profiling.py), never by a call.
* Live ends (csrc/smc_common.cuh): a kernel of one block a row finds them
  on the card from the rows the launch receives (`live_periods`, before
  B1 / B2; SMCOp keeps them for B3) and adds the rows' trimmed and whole
  instance-sites to two more device counters (TRIM_COUNTS).  The unsplit
  kernels change only their loop bounds (the row is uniform over a block);
  the split ones end each row's last live segment at its end, skip the
  segments past it, and take the adjoint's exact start and the splice's
  walk from the last live segment.  Plans and grids stay those of whole
  rows.
* No tensor cores: the transition is the O(M) structured form, not a
  matrix product; a 16-state vector is far below wgmma's 64-row tile; and
  TF32 or bf16 inputs would break the rtol 1e-5 ll gate (docs/DESIGN.md,
  "Why not the MXU": bf16 gave a 0.4% ll error on the TPU).
* The TPU layout (128-lane tiles, 2-bit observation codes in SMEM, the
  16-chunk split, the VMEM tile-block chooser) is not carried over.
"""

from __future__ import annotations

import functools

import torch

from phlash_tpu_torch import profiling
from phlash_tpu_torch.ops import split
from phlash_tpu_torch.ops.build import check, load_library, ptr, require_cuda, stream
from phlash_tpu_torch.ops.split import (CHECK_PERIODS, INSTANCES_PER_BLOCK,  # noqa: F401
                                        MIN_SEGMENT_SITES, Plan, launch_geometry, segments,
                                        sm_count)

NORM_EVERY = 8  # sites between rescalings (pallas_smc.NORM_EVERY)
TINY_NORM = 1e-30  # normalizer clamp (pallas_smc.TINY_NORM)
SUPPORTED_M = (8, 16, 32, 64)  # template instances of the CUDA kernels
# the kernels' mapping (csrc/smc_common.cuh's PHLASH_SMC_INSTANCES; the
# library reports it, a test reads the header)
STATES_PER_LANE = {8: 2, 16: 4, 32: 2, 64: 4}
# the warps a split launch aims for on each SM, by direction (set by the K
# sweeps, PERF.md §6): the forward's kernels hold 32 one-warp blocks an SM,
# the adjoint's 16 (csrc/smc_common.cuh's ADJOINT_WARPS_PER_SM: its period
# cache in shared memory, at most 128 registers a thread), and a second wave
# of the adjoint only lengthens it, so its target is also capped by what the
# built kernel holds (resident_warps)
TARGET_WARPS_PER_SM = {"forward": 16, "adjoint": 16}
# the split launches' device counters, in csrc's SplitCount order
DEVICE_COUNTS = ("smc_segments", "smc_segments_resolved", "smc_fix_sites", "smc_split_sites")
# the live ends' device counters, in csrc's TrimCount order: the instance-sites
# past the rows' live ends and all instance-sites of the trimming forward launches
TRIM_COUNTS = ("smc_trimmed_sites", "smc_row_sites")
tally = profiling.Tally(("forward_cuda", "forward_cuda_residuals", "backward_cuda",
                         "forward_plain", "backward_plain"))
counts, reset_counts, add_counts = tally.counts, tally.reset, tally.add_counts
device_tally = split.DeviceCounters(DEVICE_COUNTS)
device_counts, reset_device_counts = device_tally.counts, device_tally.reset
trim_tally = split.DeviceCounters(TRIM_COUNTS)
trim_counts, reset_trim_counts = trim_tally.counts, trim_tally.reset
# the split adjoint's host tallies in the fit's record: its launches, and the
# warps they put on the card (K x the unsplit grid's warps, a launch): their
# ratio over the SM count is the warps an SM the adjoint's plan asked for
SPLIT_COUNTS = ("smc_adjoint_split_launches", "smc_adjoint_split_warps")
split_tally = profiling.Tally(SPLIT_COUNTS, fit_record=True)


def n_periods(L: int) -> int:
    return -(-L // NORM_EVERY)


def segment_plan(B: int, S: int, L: int, M: int, sms: int | None = None,
                 direction: str = "forward", resident: int | None = None) -> Plan:
    """How the CUDA kernels of `direction` ("forward": B1 / B2, "adjoint":
    B3) split a launch's rows: split.plan's K, where the unsplit grid's
    warps times K reach TARGET_WARPS_PER_SM[direction] on each of the
    device's `sms` SMs (the current CUDA device's when None), and no
    segment is shorter than MIN_SEGMENT_SITES sites.  The adjoint's target
    never exceeds `resident`, the warps an SM its split kernel holds
    (resident_warps on the current CUDA device when None; the forward
    ignores it).  K = 1 wherever the instances already fill the card or the
    rows are short."""
    warps = launch_geometry(B, S, M, STATES_PER_LANE[M], INSTANCES_PER_BLOCK)["warps"]
    target = TARGET_WARPS_PER_SM[direction]
    if direction == "adjoint":
        if resident is None:
            resident = resident_warps(M, torch.cuda.current_device())
        target = min(target, resident)
    return split.plan(warps, target, L, n_periods(L), sms)


@functools.lru_cache(maxsize=None)
def resident_warps(M: int, device: int, shared: bool = True) -> int:
    """The warps an SM the split adjoint's speculative kernel at M holds on
    CUDA device `device` (its index), its period cache in shared memory
    (`shared`: the adjoint plan's ceiling) or in registers, as the library's
    cudaOccupancyMaxActiveBlocksPerMultiprocessor counts its blocks.  Asked
    once a device."""
    _check_m(M)
    lib = load_library()
    with torch.cuda.device(device):
        blocks = lib.lib.phlash_smc_adjoint_split_blocks_per_sm(M, int(shared))
    if blocks < 0:
        check(lib, -blocks, "smc adjoint occupancy query")
    threads = launch_geometry(1, 1, M, STATES_PER_LANE[M], INSTANCES_PER_BLOCK)["threads_per_block"]
    return blocks * -(-threads // 32)


def shared_cache(B: int, S: int, M: int, K: int, sms: int, register_warps: int) -> bool:
    """Whether the split adjoint at K segments keeps its period cache in
    shared memory: where its warps exceed what its register-cache kernels
    hold on `sms` SMs at `register_warps` an SM (resident_warps(...,
    shared=False))."""
    warps = launch_geometry(B, S, M, STATES_PER_LANE[M], INSTANCES_PER_BLOCK)["warps"]
    return K * warps > register_warps * sms


def kernel_geometry(B: int, S: int, M: int) -> dict:
    """launch_geometry of the CUDA kernels at M, from the mapping the built
    library reports (csrc/smc_common.cuh owns it), and the warps an SM the
    split adjoint holds on the current device with its period cache in
    shared memory and in registers (`adjoint_resident_warps`,
    `adjoint_register_warps`)."""
    _check_m(M)
    lib = load_library().lib
    geo = launch_geometry(B, S, M, lib.phlash_smc_states_per_lane(M),
                          lib.phlash_smc_instances_per_block())
    index = torch.cuda.current_device()
    return dict(geo, adjoint_resident_warps=resident_warps(M, index),
                adjoint_register_warps=resident_warps(M, index, False))


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


def live_periods(obs: torch.Tensor, B: int = 1) -> torch.Tensor:
    """Each row's live end (S,) int32: the periods up to and including the
    one that holds the row's last observed site (code 0 or 1), 0 where the
    row has none.  On CUDA a hand kernel (a block a row), which also adds
    the rows' trimmed and whole instance-sites, B instances a row, to the
    device counters TRIM_COUNTS; on the CPU plain PyTorch, counting nothing."""
    S, L = obs.shape
    if obs.device.type == "cuda":
        dev = obs.device
        if obs.dtype != torch.int8 or not obs.is_contiguous() or S * L == 0:
            raise ValueError("observation rows must be non-empty contiguous int8")
        live = torch.empty(S, dtype=torch.int32, device=dev)
        lib = load_library()
        with torch.cuda.device(dev):
            err = lib.lib.phlash_smc_live_periods(ptr(obs), S, L, B, ptr(live),
                                                  ptr(trim_tally.on(dev)), stream(dev))
        check(lib, err, "smc_live launch")
        return live
    if obs.device.type != "cpu":
        raise ValueError(f"no live ends for device {obs.device}")
    seen = (obs == 0) | (obs == 1)
    last = torch.where(seen, torch.arange(L, device=obs.device), -1).amax(1)
    return torch.where(last >= 0, last // NORM_EVERY + 1, 0).to(torch.int32)


def _live_mask(live, obs: torch.Tensor, q: int) -> torch.Tensor:
    "(1, S, 1): whether period q lies below each row's live end (every row where live is None)."
    if live is None:
        return torch.ones(1, obs.shape[0], 1, dtype=torch.bool, device=obs.device)
    return (q < live.to(obs.device)).view(1, -1, 1)


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


def forward_structured(params, pi: torch.Tensor, obs: torch.Tensor, with_residuals: bool = True,
                       live: torch.Tensor | None = None):
    """Plain forward: (ll (B, S), alpha (B, S, M), pstates (n_per, S, B, M) or
    None), each row up to its live end (`live`; whole rows where None):
    alpha is the state there, pstates zero from there on."""
    tally.add("forward_plain")
    prm = _rows(params)
    a = pi
    ll = torch.zeros(pi.shape[:2], dtype=pi.dtype, device=pi.device)
    pst = []
    for q in range(n_periods(obs.shape[1])):
        on = _live_mask(live, obs, q)
        if with_residuals:
            pst.append(torch.where(on, a, 0))
        a_q, c = _forward_period(prm, a, obs, q)
        a = torch.where(on, a_q, a)
        ll = ll + torch.where(on[..., 0], torch.log(c), 0)
    pstates = torch.stack(pst).transpose(1, 2).contiguous() if with_residuals else None
    return ll, a, pstates


def backward_structured(params, obs: torch.Tensor, pstates: torch.Tensor, gbar: torch.Tensor,
                        abar0: torch.Tensor, live: torch.Tensor | None = None):
    """Plain adjoint: gbar (B, S) cotangent of ll, abar0 (B, S, M) cotangent
    of the final state (the state at each row's live end with `live`).
    Returns ((db, dd, du, dvv, de0, de1), dpi), each (B, S, M) per instance."""
    tally.add("backward_plain")
    prm = _rows(params)
    acc = (torch.zeros_like(abar0),) * 6
    ab = abar0
    g = gbar[..., None]
    for q in reversed(range(n_periods(obs.shape[1]))):
        on = _live_mask(live, obs, q)
        ab_q, acc_q = _reverse_period(prm, pstates[q].transpose(0, 1), obs, q, ab, g, acc)
        ab = torch.where(on, ab_q, ab)
        acc = tuple(torch.where(on, x, o) for o, x in zip(acc, acc_q))
    return acc, ab


# ---------------------------------------------------------------------------
# the split path in plain PyTorch (csrc/smc_forward.cu, smc_backward.cu)
# ---------------------------------------------------------------------------


def forward_segmented(params, pi: torch.Tensor, obs: torch.Tensor, with_residuals: bool,
                      plan: Plan, live: torch.Tensor | None = None):
    """The split forward of the CUDA kernels (csrc/smc_forward.cu) in plain
    PyTorch, `plan.K` segments (split.forward_segmented on this pair's
    period), each row up to its live end (`live`).  Returns
    forward_structured's (ll, alpha, pstates or None) and the four counts
    (DEVICE_COUNTS) the kernels add on the card.  pstates and alpha are
    forward_structured's bit for bit; ll is the same log c's summed by
    interval, segment and row."""
    prm = _rows(params)

    def period(a, q):
        a, c = _forward_period(prm, a, obs, q)
        return a, torch.log(c)

    ll, alpha, st, c = split.forward_segmented(period, pi, obs.shape[1], NORM_EVERY, plan,
                                               DEVICE_COUNTS, live)
    pstates = torch.stack(st).transpose(1, 2).contiguous() if with_residuals else None
    return ll, alpha, pstates, c


def backward_segmented(params, obs: torch.Tensor, pstates: torch.Tensor, gbar: torch.Tensor,
                       abar0: torch.Tensor, plan: Plan, live: torch.Tensor | None = None):
    """The split adjoint of the CUDA kernels (csrc/smc_backward.cu) in plain
    PyTorch (split.backward_segmented: each row's last live segment from
    abar0, the others from zero).  Returns backward_structured's ((db, dd, du, dvv,
    de0, de1), dpi), the same terms summed by interval, segment and row,
    and the four counts."""
    prm = _rows(params)
    g = gbar[..., None]

    def reverse(ab, q, acc):
        return _reverse_period(prm, pstates[q].transpose(0, 1), obs, q, ab, g, acc)

    return split.backward_segmented(reverse, abar0, (torch.zeros_like(abar0),) * 6, obs.shape[1],
                                    NORM_EVERY, plan, DEVICE_COUNTS, live)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _check_m(M: int) -> None:
    if M not in SUPPORTED_M:
        raise ValueError(f"the CUDA SMC kernels support M in {SUPPORTED_M}, got {M}")


def _check_shapes(params, obs, B: int, S: int, M: int, L: int, live=None) -> None:
    _check_m(M)
    if B * S == 0 or L == 0:
        raise ValueError(f"empty launch: B={B}, S={S}, L={L}")
    if any(tuple(p.shape) != (B, M) for p in params) or tuple(obs.shape) != (S, L):
        raise ValueError("parameter rows must be (B, M) and observations (S, L)")
    if live is not None and (live.dtype != torch.int32 or tuple(live.shape) != (S,)
                             or not live.is_contiguous() or live.device != obs.device):
        raise ValueError("live ends must be contiguous int32 (S,) on the observations' device")


def forward_cuda(params, pi: torch.Tensor, obs: torch.Tensor, with_residuals: bool = True,
                 live: torch.Tensor | None = None):
    "The forward kernels (B1 without residuals, B2 with); shapes as the plain version."
    out = forward_launch(params, pi, obs, with_residuals, live=live)
    tally.add("forward_cuda")
    tally.add("forward_cuda_residuals", int(with_residuals))
    return out


def forward_launch(params, pi: torch.Tensor, obs: torch.Tensor, with_residuals: bool,
                   plan: Plan | None = None, live: torch.Tensor | None = None):
    """The forward kernels at `plan` (segment_plan's where None, as
    forward_cuda runs them; the card's gates also run K = 1 beside it), each
    row up to its live end (`live`).  Counts no launch."""
    B, S, M = pi.shape
    L = obs.shape[1]
    dev = require_cuda([*params, pi], [obs])
    _check_shapes(params, obs, B, S, M, L, live)
    plan = plan or segment_plan(B, S, L, M, sm_count(dev))
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
                *map(ptr, params), ptr(pi), ptr(obs), ptr(live), B, S, L, M,
                ptr(ll), ptr(alpha), ptr(pstates), stream(dev),
            )
        else:
            n_chk = -(-n_per // CHECK_PERIODS)
            ckpt = None if with_residuals else torch.empty(n_chk, S, B, M, **f32)
            work = [torch.empty(n, S, B, **f32) for n in (n_chk, K)]  # interval, segment ll
            ends = [torch.empty(K, S, B, M, **f32) for _ in range(2)]  # speculative, stored
            err = lib.lib.phlash_smc_forward_split(
                *map(ptr, params), ptr(pi), ptr(obs), ptr(live), B, S, L, M, K, P,
                ptr(ll), ptr(alpha), ptr(pstates), ptr(ckpt), *map(ptr, work), *map(ptr, ends),
                ptr(device_tally.on(dev)), stream(dev),
            )
    check(lib, err, "smc_forward launch")
    return ll, alpha, pstates


def backward_cuda(params, obs: torch.Tensor, pstates: torch.Tensor, gbar: torch.Tensor,
                  abar0: torch.Tensor, live: torch.Tensor | None = None):
    """The adjoint kernels (B3); shapes as the plain version.  A split launch
    also adds to SPLIT_COUNTS."""
    B, S, M = abar0.shape
    dev = require_cuda([abar0], [obs])
    _check_m(M)
    plan = _adjoint_plan(B, S, obs.shape[1], M, dev)
    out = backward_launch(params, obs, pstates, gbar, abar0, plan, live)
    tally.add("backward_cuda")
    if plan.K > 1:
        warps = launch_geometry(B, S, M, STATES_PER_LANE[M], INSTANCES_PER_BLOCK)["warps"]
        split_tally.add("smc_adjoint_split_launches")
        split_tally.add("smc_adjoint_split_warps", plan.K * warps)
    return out


def _adjoint_plan(B: int, S: int, L: int, M: int, dev: torch.device) -> Plan:
    return segment_plan(B, S, L, M, sm_count(dev), "adjoint", resident_warps(M, dev.index))


def backward_launch(params, obs: torch.Tensor, pstates: torch.Tensor, gbar: torch.Tensor,
                    abar0: torch.Tensor, plan: Plan | None = None,
                    live: torch.Tensor | None = None):
    """The adjoint kernels at `plan` (as forward_launch), a split one with its
    period cache in registers where its warps fit what those kernels hold on
    the card, else in shared memory.  Counts no launch."""
    B, S, M = abar0.shape
    L = obs.shape[1]
    dev = require_cuda([*params, pstates, gbar, abar0], [obs])
    _check_shapes(params, obs, B, S, M, L, live)
    plan = plan or _adjoint_plan(B, S, L, M, dev)
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
                *map(ptr, params), ptr(obs), ptr(pstates), ptr(gbar), ptr(abar0), ptr(live),
                B, S, L, M, *map(ptr, grads), stream(dev),
            )
        else:
            n_chk = -(-n_per // CHECK_PERIODS)
            work = [torch.empty(K, S, B, M, **f32), torch.empty(n_chk, S, B, M, **f32),
                    torch.empty(K, S, B, M, **f32), torch.empty(n_chk, 6, S, B, M, **f32),
                    torch.empty(K, 6, S, B, M, **f32)]  # top, ab_ck, spec_end, int, seg
            shared = shared_cache(B, S, M, K, sm_count(dev), resident_warps(M, dev.index, False))
            err = lib.lib.phlash_smc_backward_split(
                *map(ptr, params), ptr(obs), ptr(pstates), ptr(gbar), ptr(abar0), ptr(live),
                B, S, L, M, K, P, int(shared), *map(ptr, grads), *map(ptr, work),
                ptr(device_tally.on(dev)), stream(dev),
            )
    check(lib, err, "smc_backward launch")
    return tuple(grads[:6]), grads[6]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def forward(params, pi, obs, with_residuals: bool, live=None):
    "CUDA tensors launch the kernel, CPU tensors take the plain version."
    if obs.device.type == "cuda":
        return forward_cuda(params, pi, obs, with_residuals, live)
    if obs.device.type == "cpu":
        return forward_structured(params, pi, obs, with_residuals, live)
    raise ValueError(f"no SMC forward for device {obs.device}")


def backward(params, obs, pstates, gbar, abar0, live=None):
    "CUDA tensors launch the kernel, CPU tensors take the plain version."
    if obs.device.type == "cuda":
        return backward_cuda(params, obs, pstates, gbar, abar0, live)
    if obs.device.type == "cpu":
        return backward_structured(params, obs, pstates, gbar, abar0, live)
    raise ValueError(f"no SMC adjoint for device {obs.device}")
