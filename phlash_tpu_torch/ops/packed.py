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

Dispatch: `forward` / `backward` launch the CUDA kernel for CUDA tensors and
take the plain version for CPU tensors; there is no other path and no
fallback.  Every wrapper counts what it ran (`.launches` on the CUDA
wrappers, `.calls` on the plain versions); `reset_counts` zeroes them, and
`add_counts` adds what a CUDA graph replay launched (see ops/smc.py).

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
    (`DEFAULT_SEG`, the library's `phlash_packed_period`), 40 MB at the fit
    shape, which fits in the 50 MB L2; the adjoint rebuilds each period
    into registers (alpha before each site, v, rc) and sweeps it in
    reverse, so it writes nothing to device memory but its four outputs,
    and loads the previous period's checkpoint before the current period's
    work (P = 16 left the adjoint too few registers and ran both kernels
    slower);
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
from phlash_tpu_torch.ops.smc import launch_geometry

M = 16  # HMM states (pallas_hmm.M)
# sites per segment, the checkpoint spacing: the CUDA kernels' period
# (PACKED_PERIOD in csrc/packed_common.cuh, which the library reports)
DEFAULT_SEG = 8


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
    L = obs.shape[1]
    e0, e1 = emis0[:, None, :], emis1[:, None, :]
    At = A.transpose(-1, -2)
    g = gbar[..., None]
    ab = torch.zeros(B, S, Mx, dtype=A.dtype, device=A.device)
    dA = torch.zeros(B, S, Mx, Mx, dtype=A.dtype, device=A.device)
    de0 = torch.zeros_like(ab)
    de1 = torch.zeros_like(ab)
    for q in reversed(range(n_segments(L, seg_len))):
        a = ckpt[q].view(B, S, Mx)
        sites = []  # (obs, alpha before the site, v) per site of the segment
        for t in range(q * seg_len, min((q + 1) * seg_len, L)):
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
    return dA, de0, de1, ab


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _check_shapes(A, emis0, emis1, obs, B: int, S: int, seg_len: int) -> None:
    if seg_len != DEFAULT_SEG:
        raise ValueError(f"the packed CUDA kernels keep a checkpoint every {DEFAULT_SEG} sites "
                         f"(their period); got seg_len={seg_len}")
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
    "The forward kernel (B4); shapes as the plain version."
    B, S, _ = pi.shape
    L = obs.shape[1]
    _check_shapes(A, emis0, emis1, obs, B, S, seg_len)
    dev = require_cuda([A, emis0, emis1, pi], [obs])
    if tuple(pi.shape) != (B, S, M):
        raise ValueError(f"pi must be (B, S, {M})")
    lib = load_library()
    ll = torch.empty(B, S, dtype=torch.float32, device=dev)
    ckpt = None
    if with_ckpt:
        ckpt = torch.empty(n_segments(L, seg_len), B * S, M, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lib.phlash_packed_forward(
            ptr(A), ptr(emis0), ptr(emis1), ptr(pi), ptr(obs), B, S, L, ptr(ll), ptr(ckpt),
            stream(dev),
        )
    check(lib, err, "packed_forward launch")
    forward_packed_cuda.launches += 1
    return ll, ckpt


def backward_packed_cuda(A, emis0, emis1, obs, ckpt, gbar, seg_len: int = DEFAULT_SEG):
    "The adjoint kernel (B5); shapes as the plain version."
    B, S = gbar.shape
    L = obs.shape[1]
    _check_shapes(A, emis0, emis1, obs, B, S, seg_len)
    dev = require_cuda([A, emis0, emis1, ckpt, gbar], [obs])
    if tuple(ckpt.shape) != (n_segments(L, seg_len), B * S, M):
        raise ValueError(f"ckpt must be (n_seg, B * S, {M})")
    lib = load_library()
    # the four outputs are all the kernel writes: the history stays in registers
    dA = torch.empty(B, S, M, M, dtype=torch.float32, device=dev)
    de0, de1, dpi = (torch.empty(B, S, M, dtype=torch.float32, device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        err = lib.lib.phlash_packed_backward(
            ptr(A), ptr(emis0), ptr(emis1), ptr(obs), ptr(ckpt), ptr(gbar), B, S, L,
            ptr(dA), ptr(de0), ptr(de1), ptr(dpi), stream(dev),
        )
    check(lib, err, "packed_backward launch")
    backward_packed_cuda.launches += 1
    return dA, de0, de1, dpi


# ---------------------------------------------------------------------------
# dispatch and counters
# ---------------------------------------------------------------------------


def forward(A, emis0, emis1, pi, obs, seg_len: int, with_ckpt: bool):
    "CUDA tensors launch the kernel, CPU tensors take the plain version."
    if obs.device.type == "cuda":
        return forward_packed_cuda(A, emis0, emis1, pi, obs, seg_len, with_ckpt)
    if obs.device.type == "cpu":
        return forward_packed(A, emis0, emis1, pi, obs, seg_len, with_ckpt)
    raise ValueError(f"no packed forward for device {obs.device}")


def backward(A, emis0, emis1, obs, ckpt, gbar, seg_len: int):
    "CUDA tensors launch the kernel, CPU tensors take the plain version."
    if obs.device.type == "cuda":
        return backward_packed_cuda(A, emis0, emis1, obs, ckpt, gbar, seg_len)
    if obs.device.type == "cpu":
        return backward_packed(A, emis0, emis1, obs, ckpt, gbar, seg_len)
    raise ValueError(f"no packed adjoint for device {obs.device}")


def reset_counts() -> None:
    forward_packed_cuda.launches = backward_packed_cuda.launches = 0
    forward_packed.calls = backward_packed.calls = 0


def counts() -> dict:
    return dict(
        forward_cuda=forward_packed_cuda.launches, backward_cuda=backward_packed_cuda.launches,
        forward_plain=forward_packed.calls, backward_plain=backward_packed.calls,
    )


def add_counts(n: dict) -> None:
    "Add `n`, a dict as counts() gives it, to the counters."
    forward_packed_cuda.launches += n["forward_cuda"]
    backward_packed_cuda.launches += n["backward_cuda"]
    forward_packed.calls += n["forward_plain"]
    backward_packed.calls += n["backward_plain"]


reset_counts()
