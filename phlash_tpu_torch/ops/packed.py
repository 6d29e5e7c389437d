"""Dense-transition ("packed") forward and adjoint: plain PyTorch versions
and CUDA kernels.

Port of phlash_tpu/ops/pallas_hmm.py (B4, forward_packed) and
phlash_tpu/ops/pallas_hmm_vjp.py (B5, backward_packed).  Each (particle p,
chunk s) pair is one HMM instance i = p * S + s with M = 16 states.  Per
site the forward computes

    v = alpha @ A,   u = v * f(obs),   c = sum(u),   alpha = u / c,   ll += log c

with f = emis0 for hom, emis1 for het, 1 for missing, and no clamp on c.
Padding (-2, or a site past the row's end) freezes alpha and ll.  With
checkpoints on, the forward stores alpha at the start of every segment of
`seg_len` sites.  The adjoint rebuilds each segment from its checkpoint and
sweeps it in reverse (given abar = dL/dalpha and g = dL/dll):

    ubar = (abar - <abar, alpha> + g) / c,   w = live ? ubar * f : 0,
    abar <- live ? w @ A^T : abar,   dA += alpha_prev^T w,
    de0 / de1 += v * ubar (routed by the observation, live sites only),
    dpi = the final abar.

Shapes, shared by both versions:
    A (B, 16, 16); emis0, emis1 (B, 16); pi (B, S, 16); obs (S, L) int8
    ll (B, S); ckpt (n_seg, B * S, 16), n_seg = ceil(L / seg_len): alpha at
    every segment start (the CUDA kernels take seg_len = DEFAULT_SEG only)
    gradients per instance: dA (B, S, 16, 16), de0, de1, dpi (B, S, 16)
    (the caller sums the chunk axis, so no atomics and a fixed order)

Dispatch: `forward` / `backward` launch the CUDA kernels for CUDA tensors
(split as `segment_plan` says) and take the plain version for CPU tensors;
there is no other path and no fallback.  `forward_segmented` /
`backward_segmented` render the split in plain PyTorch for the tests (and
phase 12b's rehearsal on the CPU).  Every wrapper counts what it ran (`.launches` on the CUDA
wrappers, `.calls` on the plain versions); `reset_counts` zeroes them, and
`add_counts` adds what a CUDA graph replay launched (see ops/smc.py).
Beside the launches, `forward` / `backward` tally on the host the work
each call swept, from its shapes (`work`, `reset_work`; WORK_COUNTS):
`packed_sites`, the instance-sites B * S * L of every forward and adjoint
(padding included: the kernels sweep it), and `packed_ckpt_bytes`, the
checkpoint bytes each forward with checkpoints wrote.  A graph replay
calls neither, so training.Caller adds what its capture tallied through
`add_counts`, as it adds the launches; the fit's record (profiling.py)
zeroes the tallies when the fit opens and reads them when it closes.

Kernel design note (csrc/packed_common.cuh, packed_forward.cu,
packed_backward.cu).
* Replaces: B4 = pallas_hmm.forward_packed (body _fwd_kernel) by one
  forward kernel whose checkpoint store is switched by a null pointer; B5 =
  pallas_hmm_vjp.backward_packed (body _bwd_kernel) by the adjoint kernel.
* What bounds it on the H100: neither bytes nor FLOPs but latency.  Per
  site an instance does ~560 flops (a 16 x 16 matrix-vector product, the
  emission, the sum, the reciprocal, the log) that cannot start before the
  previous site's normalizer is known, and there are only B * S independent
  chains: 2500 at the fit shape.  Handing states between lanes takes warp
  shuffles, and the shuffle pipe, shared by every warp of an SM, is the
  other limit.
* What the design does about it:
  - states on lanes: a group of G = 16 / SPL lanes runs one instance, SPL
    states a lane, with the lane's columns of A (and, in the adjoint, its
    rows of A and of dA) in registers; one SPL per kernel, the faster one
    that builds without spill (`PACKED_FWD_SPL` = 4, `PACKED_BWD_SPL` = 1,
    reported by `kernel_geometry`).  A lane receives the other lanes'
    states by xor shuffles and keeps A in that order, so every register
    index is a compile-time constant; more states a lane means fewer
    shuffles an instance ((G - 1) * SPL shuffles and log2 G butterfly
    steps a site for 32 / G instances a warp) but fewer warps and more
    registers;
  - a short chain: the forward carries the state unnormalized (alpha =
    x * rho), so the next site's product waits only for x while the
    butterfly and the reciprocal that give rho = 1 / c run beside it; the
    16-term product runs as independent partial sums; each site takes one
    reciprocal (the fast path of IEEE rcp.rn.f32, c lying within
    [smallest emission, 1]) instead of a division a state; nothing branches
    on the observation, so each period is one basic block;
  - the dense residual: the forward stores alpha every P = 8 sites
    (`DEFAULT_SEG`, the library's `phlash_packed_period`): ceil(L / 8) x
    B * S x 16 float32, 40 MB at B = 500, S = 5, L = 2,000, which fits in
    the 50 MB L2, but 376 MB at a genome's chunk (B = 500, S = 1,
    L = 94,000), which does not: there B4 writes them to HBM and B5 reads
    them back, 0.75 GB an iteration, ~0.22 ms at 3.35 TB/s beside the
    chains' ~30 ms, so the bytes still do not bound it.  The adjoint
    rebuilds each period into registers (alpha before each site, v, rc)
    and sweeps it in reverse, so it writes nothing to device memory but
    its four outputs, and loads the previous period's checkpoint before
    the current period's work (P = 16 left the adjoint too few registers
    and ran both kernels slower);
  - the fused dA row: the w values that form w A^T by shuffles also update
    the lane's rows of dA (dA[m, :] += alpha_prev[m] w), so the rank-one
    update costs no shuffle; <abar, alpha> is sum_j w'_j v'_j of the live
    site after (abar = w' A^T, v' = alpha A), so its butterfly runs beside
    the next shuffles, not before them;
  - chunk-major blocks: a block holds 8 instances of one chunk, stages
    that chunk's observation row into shared memory (csrc/smc_common.cuh's
    stage_obs, 1024 sites a tile, so any L works) and every lane reads its
    site's code as a broadcast; no lane skips a site (padding is a select),
    so the full-warp shuffles never sit in a divergent branch, and groups
    past the last particle compute on a clamped copy and store nothing;
  - gradients are written per instance and summed over chunks in PyTorch:
    deterministic, no atomics; ll is summed per period, then across
    periods, each log taken by one lane of the group.
* Segments along the row, where the instances leave the card nearly empty
  (one genome: 500 instances on rows of ~94,000 sites, 63 warps for B4 and
  252 for B5 on 132 SMs, so each kernel waited on one instance's chain of
  94,000 sites).  `segment_plan` takes K from the launch's warps, the SM
  count and L only (smc.split_count, the SMC' kernels' rule, with this
  pair's TARGET_WARPS_PER_SM); K = 1 launches the unsplit kernels above.
  The filter forgets its start: two states run through the same sites
  meet, and once the carried state of two chains holds the same bits,
  every later site is the same computation.  So each row is cut into K
  segments of P periods (P a multiple of CHECK_PERIODS, so each segment
  checkpoints and takes its logs where the unsplit kernel does), and each
  direction runs three launches on grid (ceil(B / 8), S, K):
  - speculate: every segment from a guess (the forward from pi, segment 0
    exact; the adjoint from abar = 0, which is the last segment's true
    start), storing its trajectory (the checkpoints, and every CHECK_PERIODS
    periods the carried state), each interval's sums (log c; the lane's rows
    of dA, de0, de1) and its end;
  - fix: segment k from its neighbour's speculative end, comparing the
    carried state with the stored one at each checkpoint: (x, rho) in the
    forward, not alpha = x rho (two chains with the same rounded alpha can
    still part later); (abar, <abar, alpha>) in the adjoint, its look-ahead
    included.  At the first bitwise match it stops, and before that its
    checkpoints, states and interval sums replace the speculative ones;
  - splice: a group an instance walks the segments in order from the exact
    one and re-runs, as the fix does, any segment whose stored trajectory did
    not start from its neighbour's true end.  A row that never forgets
    costs the unsplit time plus the two passes and never gives another
    answer.
  The checkpoints are bitwise the unsplit B4's, so B5 rebuilds every period
  from spliced states, never speculative ones; ll and the gradients are
  the same terms summed by interval, segment and then row in a fixed order
  (no float atomics).  The adjoint's interval sums are 18 rows of 16 floats
  an instance an interval (423 MB at a genome's chunk), its largest
  workspace.  The flags and sums live in per-call workspace; the four
  device counters (DEVICE_COUNTS) are integer atomics, zeroed and read by
  the fit's record (profiling.py), never by a call.
* No tensor cores: the product is 16 x 16 per instance, far below wgmma's
  64-row tile, and TF32 or bf16 would break the rtol 1e-5 ll gate
  (docs/DESIGN.md, "Why not the MXU": bf16 gave a 0.4% ll error on the
  TPU).  float32 IEEE arithmetic throughout, no fast-math.
* The TPU layout (8 particles' A block-diagonal in 128 x 128 MXU tiles,
  8-row chunk tiles, 2-bit observation codes in SMEM) is not carried over:
  each group reads its particle's A and its block's raw int8 row, so any
  S works and no packing pass runs.
"""

from __future__ import annotations

import torch

from phlash_tpu_torch.ops.build import check, load_library, ptr, require_cuda, stream
from phlash_tpu_torch.ops.smc import (CHECK_PERIODS, INSTANCES_PER_BLOCK, DeviceCounters, Plan,
                                      _keep, _same, _sm_count, launch_geometry, segments,
                                      split_count)

M = 16  # HMM states (pallas_hmm.M)
# sites per segment, the checkpoint spacing: the CUDA kernels' period
# (PACKED_PERIOD in csrc/packed_common.cuh, which the library reports)
DEFAULT_SEG = 8
WORK_COUNTS = ("packed_sites", "packed_ckpt_bytes")  # the host tallies of `work`
_work = dict.fromkeys(WORK_COUNTS, 0)
# the kernels' states per lane by direction (PACKED_FWD_SPL, PACKED_BWD_SPL in
# csrc/packed_common.cuh; a test reads the header), and the warps a split
# launch aims for on each SM (set by the K sweeps, PERF.md §6): the forward's
# split kernels hold 16 one-warp blocks an SM, but its chains meet late
# (~1,000 sites), so past 8 the longer fix share outweighs the occupancy; the
# adjoint's hold 3 blocks of 4 warps (170 registers), and a second wave
# only lengthens it
STATES_PER_LANE = {"forward": 4, "adjoint": 1}
TARGET_WARPS_PER_SM = {"forward": 8, "adjoint": 12}
# the split launches' device counters, in csrc's SplitCount order
DEVICE_COUNTS = ("packed_segments", "packed_segments_resolved", "packed_fix_sites",
                 "packed_split_sites")


def n_segments(L: int, seg_len: int) -> int:
    return -(-L // seg_len)


def _emission(ob, e0, e1):
    "f(obs): (1, S, 1) codes against (B, 1, M) emission rows -> (B, S, M)."
    return torch.where(ob == 0, e0, torch.where(ob == 1, e1, torch.ones_like(e0)))


# ---------------------------------------------------------------------------
# plain PyTorch versions (any dtype, any device)
# ---------------------------------------------------------------------------


def forward_packed(A, emis0, emis1, pi, obs, seg_len: int = DEFAULT_SEG, with_ckpt: bool = True):
    "Plain forward: (ll (B, S), ckpt (n_seg, B * S, M) or None)."
    forward_packed.calls += 1
    B, S, Mx = pi.shape
    e0, e1 = emis0[:, None, :], emis1[:, None, :]
    a = pi
    ll = torch.zeros(B, S, dtype=pi.dtype, device=pi.device)
    ckpt = []
    for t in range(obs.shape[1]):
        if with_ckpt and t % seg_len == 0:
            ckpt.append(a.reshape(B * S, Mx))
        ob = obs[:, t].view(1, S, 1)
        u = torch.matmul(a, A) * _emission(ob, e0, e1)
        c = u.sum(-1, keepdim=True)
        live = ob != -2
        a = torch.where(live, u / c, a)
        ll = ll + torch.where(live[..., 0], torch.log(c[..., 0]), 0.0)
    return ll, torch.stack(ckpt) if with_ckpt else None


def backward_packed(A, emis0, emis1, obs, ckpt, gbar, seg_len: int = DEFAULT_SEG):
    """Plain adjoint of forward_packed for the ll cotangent gbar (B, S).
    Returns per-instance (dA (B, S, M, M), de0, de1, dpi (B, S, M))."""
    backward_packed.calls += 1
    B, S = gbar.shape
    Mx = A.shape[-1]
    ab = torch.zeros(B, S, Mx, dtype=A.dtype, device=A.device)
    acc = (torch.zeros(B, S, Mx, Mx, dtype=A.dtype, device=A.device), ab, ab)
    for q in reversed(range(n_segments(obs.shape[1], seg_len))):
        ab, acc = _reverse_sites(A, emis0, emis1, ckpt[q].view(B, S, Mx), obs, q * seg_len,
                                 (q + 1) * seg_len, ab, gbar, acc)
    return (*acc, ab)


def _reverse_sites(A, emis0, emis1, a, obs, t0: int, t1: int, ab, gbar, acc):
    """Sites [t0, t1) of the plain adjoint: rebuild them from alpha a at t0,
    sweep them in reverse from abar ab; (abar at t0, acc = (dA, de0, de1)
    plus their terms)."""
    S = obs.shape[0]
    e0, e1 = emis0[:, None, :], emis1[:, None, :]
    At = A.transpose(-1, -2)
    g = gbar[..., None]
    dA, de0, de1 = acc
    sites = []  # (obs, alpha before the site, v) per site of the segment
    for t in range(t0, min(t1, obs.shape[1])):
        ob = obs[:, t].view(1, S, 1)
        v = torch.matmul(a, A)
        sites.append((ob, a, v))
        u = v * _emission(ob, e0, e1)
        a = torch.where(ob != -2, u / u.sum(-1, keepdim=True), a)
    for ob, a_prev, v in reversed(sites):
        live = ob != -2
        f = _emission(ob, e0, e1)
        u = v * f
        c = u.sum(-1, keepdim=True)
        ubar = (ab - (ab * (u / c)).sum(-1, keepdim=True) + g) / c
        w = torch.where(live, ubar * f, 0.0)
        ab = torch.where(live, torch.matmul(w, At), ab)
        dA = dA + a_prev[..., :, None] * w[..., None, :]
        dfull = v * ubar
        de0 = de0 + torch.where(live & (ob == 0), dfull, 0.0)
        de1 = de1 + torch.where(live & (ob == 1), dfull, 0.0)
    return ab, (dA, de0, de1)


# ---------------------------------------------------------------------------
# the split path in plain PyTorch (csrc/packed_forward.cu, packed_backward.cu)
# ---------------------------------------------------------------------------


def segment_plan(B: int, S: int, L: int, sms: int | None = None,
                 direction: str = "forward") -> Plan:
    """How the CUDA kernels of `direction` ("forward": B4, "adjoint": B5)
    split a launch's rows: smc.split_count's K for the unsplit grid's warps
    (launch_geometry at STATES_PER_LANE[direction], as kernel_geometry
    reports them), TARGET_WARPS_PER_SM[direction] and the device's `sms`
    SMs (the current CUDA device's when None), in segments of whole
    checkpoint intervals.  K = 1 wherever the instances already fill the
    card or the rows are short."""
    if sms is None:
        sms = _sm_count(torch.cuda.current_device())
    warps = launch_geometry(B, S, M, STATES_PER_LANE[direction], INSTANCES_PER_BLOCK)["warps"]
    K = split_count(warps, TARGET_WARPS_PER_SM[direction], sms, L)
    return segments(n_segments(L, DEFAULT_SEG), K)


def _forward_period(A, e0, e1, a, obs, q: int):
    """Period q (DEFAULT_SEG sites) of the plain forward from alpha a: (alpha
    after it, its sum of log c (B, S)), forward_packed's arithmetic."""
    S = obs.shape[0]
    lc = torch.zeros(a.shape[:2], dtype=a.dtype, device=a.device)
    for t in range(q * DEFAULT_SEG, min((q + 1) * DEFAULT_SEG, obs.shape[1])):
        ob = obs[:, t].view(1, S, 1)
        u = torch.matmul(a, A) * _emission(ob, e0, e1)
        c = u.sum(-1, keepdim=True)
        live = ob != -2
        a = torch.where(live, u / c, a)
        lc = lc + torch.where(live[..., 0], torch.log(c[..., 0]), 0.0)
    return a, lc


def forward_segmented(A, emis0, emis1, pi, obs, plan: Plan, with_ckpt: bool = True):
    """The split forward of the CUDA kernels (csrc/packed_forward.cu) in plain
    PyTorch, `plan.K` segments (fewer where the row has too few intervals):
    speculate, fix, splice.  Returns forward_packed's (ll, ckpt or None) at
    DEFAULT_SEG and the four counts (DEVICE_COUNTS) the kernels add on the
    card.  ckpt is forward_packed's bit for bit; ll is the same log c's
    summed by period, interval, segment and row.  The plain arithmetic
    carries alpha itself, so alpha is the state compared."""
    L = obs.shape[1]
    n_per = n_segments(L, DEFAULT_SEG)
    K, P = segments(n_per, plan.K)
    B, S, Mx = pi.shape
    e0, e1 = emis0[:, None, :], emis1[:, None, :]
    false = torch.zeros((B, S), dtype=torch.bool, device=pi.device)
    st = [None] * n_per  # alpha at every period: the checkpoints
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
            a, lc = _forward_period(A, e0, e1, a, obs, q)
            acc = acc + lc
            ran += (~done) * (min((q + 1) * DEFAULT_SEG, L) - q * DEFAULT_SEG)
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
        counts["packed_split_sites"] += int(ran.sum())
    counts["packed_segments"] += K * false.numel()
    for k in range(1, K):
        met, ran = run(k, spec_end[k - 1], True)
        counts["packed_segments_resolved"] += int(met.sum())
        counts["packed_fix_sites"] += int(ran.sum())
    for k in range(1, K):
        _, ran = run(k, end[k - 1], True)
        counts["packed_fix_sites"] += int(ran.sum())
    ll = torch.zeros_like(seg_ll[0])
    for x in seg_ll:
        ll = ll + x
    ckpt = torch.stack(st).reshape(n_per, B * S, Mx) if with_ckpt else None
    return ll, ckpt, counts


def backward_segmented(A, emis0, emis1, obs, ckpt, gbar, plan: Plan):
    """The split adjoint of the CUDA kernels (csrc/packed_backward.cu) in
    plain PyTorch, as forward_segmented: speculative sweeps (every segment
    from abar = 0, the last one's true start), fix sweeps from each upper
    neighbour's speculative abar, the splice.  Returns backward_packed's
    (dA, de0, de1, dpi) at DEFAULT_SEG, the same terms summed by interval,
    segment and row, and the four counts."""
    L = obs.shape[1]
    n_per = n_segments(L, DEFAULT_SEG)
    K, P = segments(n_per, plan.K)
    B, S = gbar.shape
    Mx = A.shape[-1]
    false = torch.zeros((B, S), dtype=torch.bool, device=gbar.device)
    zero = torch.zeros(B, S, Mx, dtype=A.dtype, device=A.device)
    zeros = (torch.zeros(B, S, Mx, Mx, dtype=A.dtype, device=A.device), zero, zero)
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
            t0 = q * DEFAULT_SEG
            ab, acc = _reverse_sites(A, emis0, emis1, ckpt[q].view(B, S, Mx), obs, t0,
                                     t0 + DEFAULT_SEG, ab, gbar, acc)
            ran += (~done) * (min(t0 + DEFAULT_SEG, L) - t0)
            if q % CHECK_PERIODS == 0:
                i = q // CHECK_PERIODS
                old = int_grad.get(i, (None,) * 3)
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
        old = seg_grad[k] or (None,) * 3
        seg_grad[k] = tuple(_keep(~wrote, o, t) for o, t in zip(old, total))
        return ab, met, ran

    for k in range(K):
        spec_end[k], _, ran = run(k, zero, False)
        counts["packed_split_sites"] += int(ran.sum())
    counts["packed_segments"] += K * false.numel()
    for k in range(K - 1):
        _, met, ran = run(k, spec_end[k + 1], True)
        counts["packed_segments_resolved"] += int(met.sum())
        counts["packed_fix_sites"] += int(ran.sum())
    ab = ab_ck[(K - 1) * P // CHECK_PERIODS]
    for k in reversed(range(K - 1)):
        _, _, ran = run(k, ab, True)
        counts["packed_fix_sites"] += int(ran.sum())
        ab = ab_ck[k * P // CHECK_PERIODS]
    grads = zeros
    for x in seg_grad:
        grads = tuple(t + y for t, y in zip(grads, x))
    return (*grads, ab, counts)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _check_period(seg_len: int) -> None:
    if seg_len != DEFAULT_SEG:
        raise ValueError(f"the packed CUDA kernels keep a checkpoint every {DEFAULT_SEG} sites "
                         f"(their period); got seg_len={seg_len}")


def _check_shapes(A, emis0, emis1, obs, B: int, S: int) -> None:
    L = obs.shape[1]
    if B * S == 0 or L == 0:
        raise ValueError(f"empty launch: B={B}, S={S}, L={L}")
    if tuple(A.shape) != (B, M, M) or any(tuple(e.shape) != (B, M) for e in (emis0, emis1)):
        raise ValueError(f"the packed kernels take A (B, {M}, {M}) and emissions (B, {M})")
    if obs.shape[0] != S:
        raise ValueError("observations must be (S, L)")


def kernel_geometry(B: int, S: int) -> dict:
    """launch_geometry of the forward and adjoint kernels, from the mapping
    the built library reports (states per lane: csrc/packed_common.cuh;
    instances per block, shared with the SMC' kernels: smc_common.cuh)."""
    lib = load_library().lib
    per_block = lib.phlash_smc_instances_per_block()
    return {name: launch_geometry(B, S, M, lib.phlash_packed_states_per_lane(adjoint), per_block)
            for name, adjoint in (("forward", 0), ("backward", 1))}


def forward_packed_cuda(A, emis0, emis1, pi, obs, seg_len: int = DEFAULT_SEG,
                        with_ckpt: bool = True):
    "The forward kernels (B4); shapes as the plain version."
    _check_period(seg_len)
    out = forward_launch(A, emis0, emis1, pi, obs, with_ckpt)
    forward_packed_cuda.launches += 1
    return out


def forward_launch(A, emis0, emis1, pi, obs, with_ckpt: bool, plan: Plan | None = None):
    """The forward kernels at `plan` (segment_plan's where None, as
    forward_packed_cuda runs them; the card's gates also run K = 1 beside
    it).  Counts no launch."""
    B, S, _ = pi.shape
    L = obs.shape[1]
    _check_shapes(A, emis0, emis1, obs, B, S)
    dev = require_cuda([A, emis0, emis1, pi], [obs])
    if tuple(pi.shape) != (B, S, M):
        raise ValueError(f"pi must be (B, S, {M})")
    plan = plan or segment_plan(B, S, L, _sm_count(dev))
    lib = load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    n_per = n_segments(L, DEFAULT_SEG)
    ll = torch.empty(B, S, **f32)
    ckpt = torch.empty(n_per, B * S, M, **f32) if with_ckpt else None
    K, P = segments(n_per, plan.K)
    with torch.cuda.device(dev):
        if K == 1:
            err = lib.lib.phlash_packed_forward(
                ptr(A), ptr(emis0), ptr(emis1), ptr(pi), ptr(obs), B, S, L, ptr(ll), ptr(ckpt),
                stream(dev),
            )
        else:
            n_chk, N = -(-n_per // CHECK_PERIODS), B * S
            # checkpoint x, rho; interval and segment ll; speculative and stored ends
            work = [torch.empty(n_chk, N, M, **f32), torch.empty(n_chk, N, **f32),
                    torch.empty(n_chk, N, **f32), torch.empty(K, N, **f32)]
            ends = [torch.empty(K, N, M, **f32), torch.empty(K, N, **f32),
                    torch.empty(K, N, M, **f32), torch.empty(K, N, **f32)]
            err = lib.lib.phlash_packed_forward_split(
                ptr(A), ptr(emis0), ptr(emis1), ptr(pi), ptr(obs), B, S, L, K, P, ptr(ll),
                ptr(ckpt), *map(ptr, work), *map(ptr, ends), ptr(_counters.on(dev)),
                stream(dev),
            )
    check(lib, err, "packed_forward launch")
    return ll, ckpt


def backward_packed_cuda(A, emis0, emis1, obs, ckpt, gbar, seg_len: int = DEFAULT_SEG):
    "The adjoint kernels (B5); shapes as the plain version."
    _check_period(seg_len)
    out = backward_launch(A, emis0, emis1, obs, ckpt, gbar)
    backward_packed_cuda.launches += 1
    return out


def backward_launch(A, emis0, emis1, obs, ckpt, gbar, plan: Plan | None = None):
    "The adjoint kernels at `plan` (as forward_launch).  Counts no launch."
    B, S = gbar.shape
    L = obs.shape[1]
    _check_shapes(A, emis0, emis1, obs, B, S)
    dev = require_cuda([A, emis0, emis1, ckpt, gbar], [obs])
    n_per = n_segments(L, DEFAULT_SEG)
    if tuple(ckpt.shape) != (n_per, B * S, M):
        raise ValueError(f"ckpt must be (n_seg, B * S, {M})")
    plan = plan or segment_plan(B, S, L, _sm_count(dev), "adjoint")
    lib = load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    # the four outputs are all the unsplit kernel writes: the history stays in registers
    dA = torch.empty(B, S, M, M, **f32)
    de0, de1, dpi = (torch.empty(B, S, M, **f32) for _ in range(3))
    K, P = segments(n_per, plan.K)
    with torch.cuda.device(dev):
        if K == 1:
            err = lib.lib.phlash_packed_backward(
                ptr(A), ptr(emis0), ptr(emis1), ptr(obs), ptr(ckpt), ptr(gbar), B, S, L,
                ptr(dA), ptr(de0), ptr(de1), ptr(dpi), stream(dev),
            )
        else:
            n_chk, N = -(-n_per // CHECK_PERIODS), B * S
            # the state each segment's sweep started from, at the checkpoints and
            # at the speculative sweeps' ends (abar, look-ahead); interval and
            # segment sums of the lane's M + 2 gradient rows
            work = [torch.empty(K, N, M, **f32), torch.empty(K, N, **f32),
                    torch.empty(n_chk, N, M, **f32), torch.empty(n_chk, N, **f32),
                    torch.empty(K, N, M, **f32), torch.empty(K, N, **f32),
                    torch.empty(n_chk, M + 2, N, M, **f32), torch.empty(K, M + 2, N, M, **f32)]
            err = lib.lib.phlash_packed_backward_split(
                ptr(A), ptr(emis0), ptr(emis1), ptr(obs), ptr(ckpt), ptr(gbar), B, S, L, K, P,
                ptr(dA), ptr(de0), ptr(de1), ptr(dpi), *map(ptr, work),
                ptr(_counters.on(dev)), stream(dev),
            )
    check(lib, err, "packed_backward launch")
    return dA, de0, de1, dpi


# ---------------------------------------------------------------------------
# the split launches' device counters
# ---------------------------------------------------------------------------

_counters = DeviceCounters(DEVICE_COUNTS)


def reset_device_counts() -> None:
    "Zero the split launches' device counters (a fit's record does at its start)."
    _counters.reset()


def device_counts() -> dict:
    """DEVICE_COUNTS summed over the devices since the last reset: the
    segments the split launches ran, those whose fix met inside their own
    segment, the sites the fix chains ran and the sites split.  Reads the
    device (one sync) where a split launch ran; zeros where nothing split."""
    return _counters.read()


# ---------------------------------------------------------------------------
# dispatch and counters
# ---------------------------------------------------------------------------


def forward(A, emis0, emis1, pi, obs, seg_len: int, with_ckpt: bool):
    "CUDA tensors launch the kernel, CPU tensors take the plain version."
    if obs.device.type == "cuda":
        out = forward_packed_cuda(A, emis0, emis1, pi, obs, seg_len, with_ckpt)
    elif obs.device.type == "cpu":
        out = forward_packed(A, emis0, emis1, pi, obs, seg_len, with_ckpt)
    else:
        raise ValueError(f"no packed forward for device {obs.device}")
    B, S, _ = pi.shape
    _work["packed_sites"] += B * S * obs.shape[1]
    if with_ckpt:
        _work["packed_ckpt_bytes"] += (n_segments(obs.shape[1], seg_len) * B * S * M
                                       * out[1].element_size())
    return out


def backward(A, emis0, emis1, obs, ckpt, gbar, seg_len: int):
    "CUDA tensors launch the kernel, CPU tensors take the plain version."
    if obs.device.type == "cuda":
        out = backward_packed_cuda(A, emis0, emis1, obs, ckpt, gbar, seg_len)
    elif obs.device.type == "cpu":
        out = backward_packed(A, emis0, emis1, obs, ckpt, gbar, seg_len)
    else:
        raise ValueError(f"no packed adjoint for device {obs.device}")
    _work["packed_sites"] += gbar.numel() * obs.shape[1]
    return out


def reset_counts() -> None:
    forward_packed_cuda.launches = backward_packed_cuda.launches = 0
    forward_packed.calls = backward_packed.calls = 0


def counts() -> dict:
    return dict(
        forward_cuda=forward_packed_cuda.launches, backward_cuda=backward_packed_cuda.launches,
        forward_plain=forward_packed.calls, backward_plain=backward_packed.calls,
    )


def reset_work() -> None:
    _work.update(dict.fromkeys(WORK_COUNTS, 0))


def work() -> dict:
    "The host tallies of the work `forward` and `backward` swept (WORK_COUNTS)."
    return dict(_work)


def add_counts(n: dict) -> None:
    """Add `n`, a dict as counts() gives it, to the counters, and the work
    tallies it holds (a dict as work() gives it) to theirs."""
    forward_packed_cuda.launches += n["forward_cuda"]
    backward_packed_cuda.launches += n["backward_cuda"]
    forward_packed.calls += n["forward_plain"]
    backward_packed.calls += n["backward_plain"]
    for k in WORK_COUNTS:
        _work[k] += n.get(k, 0)


reset_counts()
