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

Dispatch: `forward` / `backward` launch the CUDA kernel for CUDA tensors
and take the plain version for CPU tensors; there is no other path and no
fallback.  Every wrapper counts what it ran (`.launches` on the CUDA
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
  chunks).  One thread per chain would run the M states serially and fill
  79 warps, 20 blocks of 128: 20 of 132 SMs.
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
* No tensor cores: the transition is the O(M) structured form, not a
  matrix product; a 16-state vector is far below wgmma's 64-row tile; and
  TF32 or bf16 inputs would break the rtol 1e-5 ll gate (docs/DESIGN.md,
  "Why not the MXU": bf16 gave a 0.4% ll error on the TPU).
* The TPU layout (128-lane tiles, 2-bit observation codes in SMEM, the
  16-chunk split, the VMEM tile-block chooser) is not carried over.
"""

from __future__ import annotations

import torch

from phlash_tpu_torch.ops.build import check, load_library, ptr, require_cuda, stream

NORM_EVERY = 8  # sites between rescalings (pallas_smc.NORM_EVERY)
TINY_NORM = 1e-30  # normalizer clamp (pallas_smc.TINY_NORM)
SUPPORTED_M = (8, 16, 32, 64)  # template instances of the CUDA kernels


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


def forward_structured(params, pi: torch.Tensor, obs: torch.Tensor, with_residuals: bool = True):
    "Plain forward: (ll (B, S), alpha (B, S, M), pstates (n_per, S, B, M) or None)."
    forward_structured.calls += 1
    b, d, u, vv, e0, e1 = (x[:, None, :] for x in params)
    one = torch.ones_like(e0)
    L = obs.shape[1]
    a = pi
    ll = torch.zeros(pi.shape[:2], dtype=pi.dtype, device=pi.device)
    pst = []
    for q in range(n_periods(L)):
        if with_residuals:
            pst.append(a)
        for t in range(q * NORM_EVERY, min((q + 1) * NORM_EVERY, L)):
            ob = _site(obs, t)
            v = b * _suffix(a) + d * a + vv * _prefix(u * a)
            f = torch.where(ob == 0, e0, torch.where(ob == 1, e1, one))
            a = torch.where(ob == -2, a, v * f)
        c = torch.clamp_min(a.sum(-1, keepdim=True), TINY_NORM)
        a = a / c
        ll = ll + torch.log(c[..., 0])
    pstates = torch.stack(pst).transpose(1, 2).contiguous() if with_residuals else None
    return ll, a, pstates


def backward_structured(params, obs: torch.Tensor, pstates: torch.Tensor, gbar: torch.Tensor,
                        abar0: torch.Tensor):
    """Plain adjoint: gbar (B, S) cotangent of ll, abar0 (B, S, M) cotangent
    of the final state.  Returns ((db, dd, du, dvv, de0, de1), dpi), each
    (B, S, M) per instance."""
    backward_structured.calls += 1
    b, d, u, vv, e0, e1 = (x[:, None, :] for x in params)
    one = torch.ones_like(e0)
    L = obs.shape[1]
    zero = torch.zeros_like(abar0)
    db = dd = du = dvv = de0 = de1 = zero
    ab = abar0
    g = gbar[..., None]
    for q in reversed(range(n_periods(L))):
        a = pstates[q].transpose(0, 1)  # (B, S, M)
        sites = []
        for t in range(q * NORM_EVERY, min((q + 1) * NORM_EVERY, L)):
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
        ab = ybar
    return (db, dd, du, dvv, de0, de1), ab


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
    "The forward kernel (B1 without residuals, B2 with); shapes as the plain version."
    B, S, M = pi.shape
    L = obs.shape[1]
    dev = require_cuda([*params, pi], [obs])
    _check_shapes(params, obs, B, S, M, L)
    lib = load_library()
    ll = torch.empty(B, S, dtype=torch.float32, device=dev)
    alpha = torch.empty(B, S, M, dtype=torch.float32, device=dev)
    pstates = None
    if with_residuals:
        pstates = torch.empty(n_periods(L), S, B, M, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lib.phlash_smc_forward(
            *map(ptr, params), ptr(pi), ptr(obs), B, S, L, M,
            ptr(ll), ptr(alpha), ptr(pstates), stream(dev),
        )
    check(lib, err, "smc_forward launch")
    forward_cuda.launches += 1
    forward_cuda.residual_launches += with_residuals
    return ll, alpha, pstates


def backward_cuda(params, obs: torch.Tensor, pstates: torch.Tensor, gbar: torch.Tensor,
                  abar0: torch.Tensor):
    "The adjoint kernel (B3); shapes as the plain version."
    B, S, M = abar0.shape
    L = obs.shape[1]
    dev = require_cuda([*params, pstates, gbar, abar0], [obs])
    _check_shapes(params, obs, B, S, M, L)
    if tuple(pstates.shape) != (n_periods(L), S, B, M) or tuple(gbar.shape) != (B, S):
        raise ValueError("pstates must be (n_per, S, B, M) and gbar (B, S)")
    if pstates.data_ptr() % 16:
        raise ValueError("pstates must start on a 16-byte boundary (the kernel reads it "
                         "by vector loads)")
    lib = load_library()
    grads = [torch.empty(B, S, M, dtype=torch.float32, device=dev) for _ in range(7)]
    with torch.cuda.device(dev):
        err = lib.lib.phlash_smc_backward(
            *map(ptr, params), ptr(obs), ptr(pstates), ptr(gbar), ptr(abar0),
            B, S, L, M, *map(ptr, grads), stream(dev),
        )
    check(lib, err, "smc_backward launch")
    backward_cuda.launches += 1
    return tuple(grads[:6]), grads[6]


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
