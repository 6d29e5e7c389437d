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
`backward_segmented` render the split (ops/split.py) in plain PyTorch for
the tests (and phase 12b's rehearsal on the CPU).  Every wrapper counts
what it ran in `tally` (`counts`, `reset_counts`, `add_counts`, as
ops/smc.py).  Beside the launches, `forward` / `backward` tally on the
host the work each call swept, from its shapes, in `work_tally` (`work`,
`reset_work`; WORK_COUNTS): `packed_sites`, the instance-sites B * S * L
of every forward and adjoint (padding included: the kernels sweep it), and
`packed_ckpt_bytes`, the checkpoint bytes each forward with checkpoints
wrote.  A graph replay adds it back as it adds the launches; the fit's
record (profiling.py) zeroes it when the fit opens and reads it when it
closes.

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
  94,000 sites).  ops/split.py holds the protocol (speculate, fix,
  splice) and the rule; `segment_plan` binds it to this pair's
  TARGET_WARPS_PER_SM, and K = 1 launches the unsplit kernels above.  Each
  row is cut into K segments of P periods (P a multiple of CHECK_PERIODS,
  so each segment checkpoints and takes its logs where the unsplit kernel
  does), three launches a direction on grid (ceil(B / 8), S, K).  The
  adjoint's guess is abar = 0, which is the last segment's true start.
  The fix compares the carried state with the stored one at each
  checkpoint: (x, rho) in the forward, not alpha = x rho (two chains with
  the same rounded alpha can still part later); (abar, <abar, alpha>) in
  the adjoint, its look-ahead included.  The checkpoints are bitwise the
  unsplit B4's, so B5 rebuilds every period from spliced states, never
  speculative ones; ll and the gradients are the same terms summed by
  interval, segment and then row in a fixed order (no float atomics).  The
  adjoint's interval sums are 18 rows of 16 floats an instance an interval
  (423 MB at a genome's chunk), its largest workspace.  The flags and sums
  live in per-call workspace; the four device counters (DEVICE_COUNTS) are
  integer atomics, zeroed and read by the fit's record (profiling.py),
  never by a call.
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

from phlash_tpu_torch import profiling
from phlash_tpu_torch.ops import split
from phlash_tpu_torch.ops.build import check, load_library, ptr, require_cuda, stream
from phlash_tpu_torch.ops.split import (CHECK_PERIODS, INSTANCES_PER_BLOCK, Plan, launch_geometry,
                                        segments, sm_count)

M = 16  # HMM states (pallas_hmm.M)
# sites per segment, the checkpoint spacing: the CUDA kernels' period
# (PACKED_PERIOD in csrc/packed_common.cuh, which the library reports)
DEFAULT_SEG = 8
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
WORK_COUNTS = ("packed_sites", "packed_ckpt_bytes")  # the host tallies of `work`
tally = profiling.Tally(("forward_cuda", "backward_cuda", "forward_plain", "backward_plain"))
counts, reset_counts, add_counts = tally.counts, tally.reset, tally.add_counts
work_tally = profiling.Tally(WORK_COUNTS, fit_record=True)
work, reset_work = work_tally.counts, work_tally.reset
device_tally = split.DeviceCounters(DEVICE_COUNTS)
device_counts, reset_device_counts = device_tally.counts, device_tally.reset


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
    tally.add("forward_plain")
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
    tally.add("backward_plain")
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
    split a launch's rows: split.plan's K for the unsplit grid's warps
    (launch_geometry at STATES_PER_LANE[direction], as kernel_geometry
    reports them), TARGET_WARPS_PER_SM[direction] and the device's `sms`
    SMs (the current CUDA device's when None), in segments of whole
    checkpoint intervals.  K = 1 wherever the instances already fill the
    card or the rows are short."""
    warps = launch_geometry(B, S, M, STATES_PER_LANE[direction], INSTANCES_PER_BLOCK)["warps"]
    return split.plan(warps, TARGET_WARPS_PER_SM[direction], L, n_segments(L, DEFAULT_SEG), sms)


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
    PyTorch, `plan.K` segments (split.forward_segmented on this pair's
    period).  Returns forward_packed's (ll, ckpt or None) at DEFAULT_SEG and
    the four counts (DEVICE_COUNTS) the kernels add on the card.  ckpt is
    forward_packed's bit for bit; ll is the same log c's summed by period,
    interval, segment and row.  The plain arithmetic carries alpha itself,
    so alpha is the state compared."""
    B, S, Mx = pi.shape
    e0, e1 = emis0[:, None, :], emis1[:, None, :]
    ll, _, st, c = split.forward_segmented(
        lambda a, q: _forward_period(A, e0, e1, a, obs, q), pi, obs.shape[1], DEFAULT_SEG, plan,
        DEVICE_COUNTS)
    ckpt = torch.stack(st).reshape(len(st), B * S, Mx) if with_ckpt else None
    return ll, ckpt, c


def backward_segmented(A, emis0, emis1, obs, ckpt, gbar, plan: Plan):
    """The split adjoint of the CUDA kernels (csrc/packed_backward.cu) in
    plain PyTorch (split.backward_segmented: every segment from abar = 0,
    the last one's true start).  Returns backward_packed's (dA, de0, de1,
    dpi) at DEFAULT_SEG, the same terms summed by interval, segment and
    row, and the four counts."""
    B, S = gbar.shape
    Mx = A.shape[-1]
    zero = torch.zeros(B, S, Mx, dtype=A.dtype, device=A.device)
    zeros = (torch.zeros(B, S, Mx, Mx, dtype=A.dtype, device=A.device), zero, zero)

    def reverse(ab, q, acc):
        t0 = q * DEFAULT_SEG
        return _reverse_sites(A, emis0, emis1, ckpt[q].view(B, S, Mx), obs, t0, t0 + DEFAULT_SEG,
                              ab, gbar, acc)

    grads, dpi, c = split.backward_segmented(reverse, zero, zeros, obs.shape[1], DEFAULT_SEG,
                                             plan, DEVICE_COUNTS)
    return (*grads, dpi, c)


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
    tally.add("forward_cuda")
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
    plan = plan or segment_plan(B, S, L, sm_count(dev))
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
                ptr(ckpt), *map(ptr, work), *map(ptr, ends), ptr(device_tally.on(dev)),
                stream(dev),
            )
    check(lib, err, "packed_forward launch")
    return ll, ckpt


def backward_packed_cuda(A, emis0, emis1, obs, ckpt, gbar, seg_len: int = DEFAULT_SEG):
    "The adjoint kernels (B5); shapes as the plain version."
    _check_period(seg_len)
    out = backward_launch(A, emis0, emis1, obs, ckpt, gbar)
    tally.add("backward_cuda")
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
    plan = plan or segment_plan(B, S, L, sm_count(dev), "adjoint")
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
                ptr(device_tally.on(dev)), stream(dev),
            )
    check(lib, err, "packed_backward launch")
    return dA, de0, de1, dpi


# ---------------------------------------------------------------------------
# dispatch
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
    work_tally.add("packed_sites", B * S * obs.shape[1])
    if with_ckpt:
        work_tally.add("packed_ckpt_bytes",
                       n_segments(obs.shape[1], seg_len) * B * S * M * out[1].element_size())
    return out


def backward(A, emis0, emis1, obs, ckpt, gbar, seg_len: int):
    "CUDA tensors launch the kernel, CPU tensors take the plain version."
    if obs.device.type == "cuda":
        out = backward_packed_cuda(A, emis0, emis1, obs, ckpt, gbar, seg_len)
    elif obs.device.type == "cpu":
        out = backward_packed(A, emis0, emis1, obs, ckpt, gbar, seg_len)
    else:
        raise ValueError(f"no packed adjoint for device {obs.device}")
    work_tally.add("packed_sites", gbar.numel() * obs.shape[1])
    return out
