"""The step's assembly: particle coordinates to HMM parameters, prior and AFS term.

`model.log_density_rows` needs, for every particle of the cloud, the seven
PSMCParams leaves that the HMM kernels read, the log prior and the AFS
term.  The plain version is the tensor code the port has always run
(MCMCParams.to_dm -> PSMCParams.from_dm, which builds SizeHistory.ect / pi
and transition.transition_matrix; log_prior; log_afs through
SizeHistory.etbl); on the card two hand kernels replace it and its
autograd backward (csrc/assembly.cu):

    A1 forward_cuda    flat (P, D) -> leaves (P, 7, M) in PSMC_FIELDS order,
                       l_prior (P,), l_afs (P,)  (zeros without an AFS)
    A2 backward_cuda   the gradient (P, D) of <g_leaves, leaves>
                       + <g_prior, l_prior> + <g_afs, l_afs>

in the cloud's dtype (float32, or float64 under double_precision_params):
the assembly is not behind ops/build.KERNEL_DTYPE's float32 cast.
`AssemblyOp` is the autograd.Function: forward A1, saving only its inputs;
backward A2.  Under no_grad (the held-out ELPD) only A1 runs.

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor takes
the plain version; there is no other path and no fallback.  Every wrapper
counts what it ran (`.launches` on the CUDA wrappers, `.calls` on the plain
versions); a CUDA graph replay, which calls no wrapper, adds what its
capture counted through `add_counts` (training.Caller does).

Kernel design note (csrc/assembly_common.cuh, csrc/assembly.cu).
* Replaces: no Pallas kernel.  phlash_tpu's SVGD step is one XLA program
  (phlash_tpu/mcmc.py:259), in which XLA fuses this assembly (phlash_tpu/
  params.py:50,154, transition.py:70,138, size_history.py:95-180,
  model.py:32,91-145) and its reverse pass into a few kernels; the port ran
  it as ~700 ATen calls forward and ~1,430 backward an iteration.
* What bounds it on the H100: latency.  The work is tiny (a few MFLOP and
  ~0.3 MB at 500 particles), but each particle's assembly is a chain of
  2M - 1 dependent sub-interval blocks (the 2x2 occupancy product), each a
  dozen libdevice calls, and a launch costs microseconds.
* What the design does about it: one launch each way.  A1 runs one thread
  a particle, walking the intervals once; it never builds the M x M
  transition (from_dm reads its three diagonals and row 0) and streams the
  occupancy, the log-survival and hazard prefix sums.  A2 runs one thread a
  (particle, coordinate): it re-runs A1's device function on dual numbers
  seeded with that coordinate, so every branch and clamp follows the values
  as torch's autograd does (test_torch_assembly holds torch's forward-mode
  tangents to its reverse mode for that reason), and it writes grad[p, d]
  without atomics: deterministic.  The AFS term's per-interval rates and
  n - 1 branch lengths sit in a scratch buffer the wrapper allocates, so
  any M and n the plain version takes is taken.
"""

from __future__ import annotations

import functools
import math

import torch

from phlash_tpu_torch.ops.build import check, load_library, ptr, stream
from phlash_tpu_torch.params import PSMC_FIELDS, MCMCParams, PSMCParams, _expand_index
from phlash_tpu_torch.size_history import SizeHistory, _W_tensor
from phlash_tpu_torch.utils import Pattern

N_LEAVES = len(PSMC_FIELDS)  # b, d, u, v, emis0, emis1, pi
DTYPES = (torch.float32, torch.float64)


@functools.lru_cache(maxsize=32)
def _widths(pattern: str) -> tuple[int, int]:
    "(M, D) of a pattern: intervals, and flat coordinates (2 + groups + 1)."
    pat = Pattern(pattern)
    return pat.M, len(pat) + 3


def _afs_consts(x: torch.Tensor, afs, afs_transform):
    "afs and afs_transform in x's dtype, as log_afs casts them (None stays None)."
    if afs is None:
        return None, None
    cast = lambda a: None if a is None else a.to(dtype=x.dtype)  # noqa: E731
    return cast(afs), cast(afs_transform)


# ---------------------------------------------------------------------------
# plain PyTorch versions (any dtype, any device)
# ---------------------------------------------------------------------------


def log_prior(mcp: MCMCParams) -> torch.Tensor:
    """Per-particle log prior: standard normal on log(rho/theta), an
    alpha-weighted smoothness penalty on log c, a beta-weighted ridge."""
    x = torch.log(mcp.rho_over_theta)
    lp = -(math.log(2.0 * math.pi) + x**2) / 2.0
    lp = lp - mcp.alpha * (torch.diff(mcp.log_c) ** 2).sum(-1)
    flat = mcp.flatten()
    return lp - mcp.beta * (flat * flat).sum(-1)


def log_afs(eta: SizeHistory, afs: torch.Tensor, afs_transform: torch.Tensor | None = None
            ) -> torch.Tensor:
    """(B,) AFS composite log-likelihood of the observed (n-1,) spectrum under
    each history's expected spectrum, both through afs_transform (identity
    when None), in the dtype of eta."""
    n = afs.shape[-1] + 1
    dtype = eta.c.dtype
    T = (torch.eye(n - 1, dtype=dtype, device=eta.c.device)
         if afs_transform is None else afs_transform.to(dtype))
    T_afs = T @ afs.to(dtype)  # constant across particles
    etbl = eta.etbl(n)  # (B, n-1)
    esfs = etbl / etbl.sum(-1, keepdim=True)
    return torch.special.xlogy(T_afs, (T * esfs[:, None, :]).sum(-1)).sum(-1)


def _assemble(init: MCMCParams, x: torch.Tensor, afs, afs_transform):
    mcps = init.unflatten(x)
    dms = mcps.to_dm()
    pp = PSMCParams.from_dm(dms)
    leaves = torch.stack([getattr(pp, k) for k in PSMC_FIELDS], -2)
    l_prior = log_prior(mcps)
    l_afs = (torch.zeros_like(l_prior) if afs is None
             else log_afs(dms.eta, afs, afs_transform))
    return leaves, l_prior, l_afs


def assemble_plain(init: MCMCParams, x: torch.Tensor, afs=None, afs_transform=None):
    """(leaves (P, 7, M), l_prior (P,), l_afs (P,)) of the flat coordinates x
    (P, D) with init's statics (pattern, theta, alpha, beta): the port's
    tensor code, packed in A1's layout."""
    assemble_plain.calls += 1
    return _assemble(init, x, afs, afs_transform)


def assemble_vjp_plain(init: MCMCParams, x: torch.Tensor, afs, afs_transform,
                       g_leaves: torch.Tensor, g_prior: torch.Tensor,
                       g_afs: torch.Tensor) -> torch.Tensor:
    "(P, D) gradient of the cotangents' dot with assemble_plain's outputs (autograd)."
    assemble_vjp_plain.calls += 1
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        outs = _assemble(init, xx, afs, afs_transform)
        pairs = [(o, g) for o, g in zip(outs, (g_leaves, g_prior, g_afs)) if o.requires_grad]
        (grad,) = torch.autograd.grad([o for o, _ in pairs], xx, [g for _, g in pairs])
    return grad


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _launch_args(init: MCMCParams, x: torch.Tensor, afs, afs_transform):
    """Validate x and the AFS constants for a launch: the C entry point's
    leading arguments (elem size, pointers, sizes, statics) and (P, D, M,
    n - 1).  The pattern's index and W come from per-device caches, so every
    tensor they point to outlives the launch."""
    M, D = _widths(init.pattern)
    dev, dtype = x.device, x.dtype
    if dev.type != "cuda":
        raise ValueError(f"the assembly kernels need CUDA tensors, got {dev}")
    if dtype not in DTYPES or x.ndim != 2 or x.shape[1] != D or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32 or float64 (P, {D}) for pattern "
                         f"{init.pattern!r}, got {dtype} {tuple(x.shape)}")
    P = x.shape[0]
    if P == 0:
        raise ValueError("empty launch: no particles")
    expand = _expand_index(init.pattern, dev)
    nm1, R, w = 0, 0, None
    if afs is not None:
        nm1 = afs.shape[-1]
        R = nm1 if afs_transform is None else afs_transform.shape[0]
        w = _W_tensor(nm1 + 1, dtype, dev)
        if afs.shape != (nm1,) or (afs_transform is not None
                                   and afs_transform.shape != (R, nm1)):
            raise ValueError(f"afs must be (n - 1,) and afs_transform (R, n - 1), got "
                             f"{tuple(afs.shape)} and "
                             f"{None if afs_transform is None else tuple(afs_transform.shape)}")
        for t in (afs, afs_transform, w):
            if t is not None and (t.device != dev or t.dtype != dtype
                                  or not t.is_contiguous()):
                raise ValueError(f"the AFS constants must be contiguous {dtype} on {dev}")
    args = (x.element_size(), ptr(x), ptr(expand), ptr(afs), ptr(afs_transform), ptr(w),
            P, D, M, nm1, R, float(init.theta), float(init.alpha), float(init.beta))
    return args, (P, D, M, nm1)


def forward_cuda(init: MCMCParams, x: torch.Tensor, afs=None, afs_transform=None):
    "A1; outputs as assemble_plain's, in x's dtype."
    args, (P, D, M, nm1) = _launch_args(init, x, afs, afs_transform)
    lib = load_library()
    leaves = torch.empty(P, N_LEAVES, M, dtype=x.dtype, device=x.device)
    l_prior = torch.empty(P, dtype=x.dtype, device=x.device)
    l_afs = torch.empty(P, dtype=x.dtype, device=x.device)
    scratch = torch.empty((2 * M + nm1) * P, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.lib.phlash_assembly_forward(*args, ptr(leaves), ptr(l_prior), ptr(l_afs),
                                              ptr(scratch), stream(x.device))
    check(lib, err, "assembly_forward launch")
    forward_cuda.launches += 1
    return leaves, l_prior, l_afs


def backward_cuda(init: MCMCParams, x: torch.Tensor, afs, afs_transform,
                  g_leaves: torch.Tensor, g_prior: torch.Tensor,
                  g_afs: torch.Tensor) -> torch.Tensor:
    "A2; the gradient as assemble_vjp_plain's, in x's dtype."
    args, (P, D, M, nm1) = _launch_args(init, x, afs, afs_transform)
    for g, shape in ((g_leaves, (P, N_LEAVES, M)), (g_prior, (P,)), (g_afs, (P,))):
        if (tuple(g.shape) != shape or g.dtype != x.dtype or g.device != x.device
                or not g.is_contiguous()):
            raise ValueError(f"a cotangent must be contiguous {x.dtype} {shape} on {x.device}, "
                             f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    lib = load_library()
    grad = torch.empty(P, D, dtype=x.dtype, device=x.device)
    scratch = torch.empty(2 * (2 * M + nm1) * P * D, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.lib.phlash_assembly_backward(*args, ptr(g_leaves), ptr(g_prior), ptr(g_afs),
                                               ptr(grad), ptr(scratch), stream(x.device))
    check(lib, err, "assembly_backward launch")
    backward_cuda.launches += 1
    return grad


# ---------------------------------------------------------------------------
# dispatch, the autograd op and counters
# ---------------------------------------------------------------------------


def forward(init, x, afs, afs_transform):
    "CUDA tensors launch A1, CPU tensors take the plain version."
    if x.device.type == "cuda":
        return forward_cuda(init, x, afs, afs_transform)
    if x.device.type == "cpu":
        return assemble_plain(init, x, afs, afs_transform)
    raise ValueError(f"no assembly for device {x.device}")


def backward(init, x, afs, afs_transform, g_leaves, g_prior, g_afs):
    "CUDA tensors launch A2, CPU tensors take the plain version."
    if x.device.type == "cuda":
        return backward_cuda(init, x, afs, afs_transform, g_leaves, g_prior, g_afs)
    if x.device.type == "cpu":
        return assemble_vjp_plain(init, x, afs, afs_transform, g_leaves, g_prior, g_afs)
    raise ValueError(f"no assembly gradient for device {x.device}")


class AssemblyOp(torch.autograd.Function):
    "(leaves (P, 7, M), l_prior (P,), l_afs (P,)) of flat coordinates x (P, D)."

    @staticmethod
    def forward(ctx, x, init, afs, afs_transform):
        ctx.init = init
        ctx.save_for_backward(x, afs, afs_transform)
        return forward(init, x, afs, afs_transform)

    @staticmethod
    def backward(ctx, g_leaves, g_prior, g_afs):
        # an unused output's cotangent arrives as zeros (materialized grads)
        x, afs, afs_transform = ctx.saved_tensors
        grad = backward(ctx.init, x, afs, afs_transform, g_leaves.contiguous(),
                        g_prior.contiguous(), g_afs.contiguous())
        return grad, None, None, None


def assemble(mcps: MCMCParams, afs=None, afs_transform=None):
    """(PSMCParams with (P, M) leaves, l_prior (P,), l_afs (P,)) of the
    particles `mcps` through AssemblyOp: A1 forward and A2 backward on the
    card, the plain version and its autograd on the CPU.  afs and
    afs_transform are cast to the particles' dtype (log_afs's)."""
    x = mcps.flatten()
    afs, afs_transform = _afs_consts(x, afs, afs_transform)
    leaves, l_prior, l_afs = AssemblyOp.apply(x, mcps, afs, afs_transform)
    return PSMCParams(*leaves.unbind(-2)), l_prior, l_afs


def reset_counts() -> None:
    forward_cuda.launches = backward_cuda.launches = 0
    assemble_plain.calls = assemble_vjp_plain.calls = 0


def counts() -> dict:
    return dict(forward_cuda=forward_cuda.launches, backward_cuda=backward_cuda.launches,
                forward_plain=assemble_plain.calls, backward_plain=assemble_vjp_plain.calls)


def add_counts(n: dict) -> None:
    "Add `n`, a dict as counts() gives it, to the counters."
    forward_cuda.launches += n["forward_cuda"]
    backward_cuda.launches += n["backward_cuda"]
    assemble_plain.calls += n["forward_plain"]
    assemble_vjp_plain.calls += n["backward_plain"]


reset_counts()
