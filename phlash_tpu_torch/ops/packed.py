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
    ll (B, S); ckpt (n_seg, B * S, 16), n_seg = ceil(L / seg_len)
    gradients per instance: dA (B, S, 16, 16), de0, de1, dpi (B, S, 16)
    (the caller sums the chunk axis, so no atomics and a fixed order)

Dispatch: `forward` / `backward` launch the CUDA kernel for CUDA tensors and
take the plain version for CPU tensors; there is no other path and no
fallback.  Every wrapper counts what it ran (`.launches` on the CUDA
wrappers, `.calls` on the plain versions); `reset_counts` zeroes them.

Kernel design note (csrc/packed_forward.cu, csrc/packed_backward.cu).
* Replaces: B4 = pallas_hmm.forward_packed (body _fwd_kernel) by one
  forward kernel whose checkpoint store is switched by a null pointer; B5 =
  pallas_hmm_vjp.backward_packed (body _bwd_kernel) by the adjoint kernel.
* What bounds it on the H100: the per-site dependence chain.  Per site an
  instance does ~560 flops (a 16 x 16 matrix-vector product, the emission,
  the sum, the division, the log) that cannot start before the previous
  site's normalizer is known; at the fit shape there are 2500 instances.
* What the design does about it: one 16-lane half-warp per instance, lane j
  owning state j and column j of A in registers, so the 2500 chains become
  40,000 threads in 1250 warps over all 132 SMs.  alpha_i reaches lane j by
  `__shfl_sync` in a fixed order over i, the normalizer by a 4-step
  `__shfl_xor_sync` butterfly (every lane gets the same bits), float32 with
  IEEE division and no tensor cores.  The adjoint keeps row j of A and
  column j of dA in registers too, and rebuilds each segment into a scratch
  (seg_len, B * S, 16) that a half-warp writes and reads coalesced.
* The TPU layout (8 particles' A block-diagonal in 128 x 128 MXU tiles,
  8-row chunk tiles, 2-bit observation codes in SMEM) is not carried over:
  each half-warp reads its particle's A and its chunk's raw int8 row, so any
  S works and no packing pass runs.
"""

from __future__ import annotations

import torch

from phlash_tpu_torch.ops.build import check, load_library, ptr, require_cuda, stream

M = 16  # HMM states (pallas_hmm.M): one state per lane of a half-warp
DEFAULT_SEG = 256  # sites per segment: the checkpoint spacing (pallas_hmm.DEFAULT_SEG)


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
    L = obs.shape[1]
    if B * S == 0 or L == 0 or seg_len <= 0:
        raise ValueError(f"empty launch: B={B}, S={S}, L={L}, seg_len={seg_len}")
    if tuple(A.shape) != (B, M, M) or any(tuple(e.shape) != (B, M) for e in (emis0, emis1)):
        raise ValueError(f"the packed kernels take A (B, {M}, {M}) and emissions (B, {M})")
    if obs.shape[0] != S:
        raise ValueError("observations must be (S, L)")


def forward_packed_cuda(A, emis0, emis1, pi, obs, seg_len: int = DEFAULT_SEG,
                        with_ckpt: bool = True):
    "The forward kernel (B4); shapes as the plain version."
    B, S, _ = pi.shape
    L = obs.shape[1]
    dev = require_cuda([A, emis0, emis1, pi], [obs])
    _check_shapes(A, emis0, emis1, obs, B, S, seg_len)
    if tuple(pi.shape) != (B, S, M):
        raise ValueError(f"pi must be (B, S, {M})")
    lib = load_library()
    ll = torch.empty(B, S, dtype=torch.float32, device=dev)
    ckpt = None
    if with_ckpt:
        ckpt = torch.empty(n_segments(L, seg_len), B * S, M, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lib.phlash_packed_forward(
            ptr(A), ptr(emis0), ptr(emis1), ptr(pi), ptr(obs), B, S, L, seg_len,
            ptr(ll), ptr(ckpt), stream(dev),
        )
    check(lib, err, "packed_forward launch")
    forward_packed_cuda.launches += 1
    return ll, ckpt


def backward_packed_cuda(A, emis0, emis1, obs, ckpt, gbar, seg_len: int = DEFAULT_SEG):
    "The adjoint kernel (B5); shapes as the plain version."
    B, S = gbar.shape
    L = obs.shape[1]
    dev = require_cuda([A, emis0, emis1, ckpt, gbar], [obs])
    _check_shapes(A, emis0, emis1, obs, B, S, seg_len)
    if tuple(ckpt.shape) != (n_segments(L, seg_len), B * S, M):
        raise ValueError("ckpt must be (n_seg, B * S, 16)")
    lib = load_library()
    # the segment being swept: alpha before each site, then v, per instance
    hist = torch.empty(2, seg_len, B * S, M, dtype=torch.float32, device=dev)
    dA = torch.empty(B, S, M, M, dtype=torch.float32, device=dev)
    de0, de1, dpi = (torch.empty(B, S, M, dtype=torch.float32, device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        err = lib.lib.phlash_packed_backward(
            ptr(A), ptr(emis0), ptr(emis1), ptr(obs), ptr(ckpt), ptr(gbar), B, S, L, seg_len,
            ptr(hist), ptr(dA), ptr(de0), ptr(de1), ptr(dpi), stream(dev),
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


reset_counts()
