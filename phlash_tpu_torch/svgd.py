"""Stein Variational Gradient Descent on flattened particle coordinates.

Port of phlash_tpu/svgd.py:79-190: RBF kernel with the median heuristic, the
SVGD direction

    phi_i = (1/P) sum_j [ K(x_j, x_i) grad_j  +  grad_{x_j} K(x_j, x_i) ],

and an amsgrad step written out to optax's rule (optax keeps the running
max of the bias-corrected second moment; torch.optim.Adam(amsgrad=True)
keeps the max of the raw one, so it would take another trajectory).
Particles are one (P, D) tensor; the caller owns the mapping to MCMCParams.

Every piece of the state is a tensor on the particles' device, the step
count included, and the step reads no Python number that changes from one
step to the next: a CUDA graph of the step (training.Caller) replays what
it captured, so a count held as a Python int would repeat the first step's
bias correction at every replay.

The functions here are the update's plain version: `SVGD.step` runs them
on a CPU cloud, and on a CUDA cloud launches the hand kernels S1-S3 of
ops/svgd.py in their place (no fallback).  `offdiag_median_select` is the
port's copy of phlash_tpu's exact bitwise median (svgd.py:32-76), a second
plain version of S2's selection that the tests hold to phlash_tpu.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from phlash_tpu_torch.ops import svgd as kernels


def median_bandwidth(sq_dists: torch.Tensor, num_particles: int) -> torch.Tensor:
    """h = med^2 / log(P), floored at 1e-12, where med is the median of the
    strict lower triangle of pairwise distances.  Every off-diagonal value
    appears twice in the full matrix, which preserves the median, so the
    diagonal is masked to +inf and the two middle order statistics of the
    sorted matrix are averaged."""
    kernels.tally.add("bandwidth_plain")
    P = num_particles
    d = torch.sqrt(sq_dists)
    eye = torch.eye(P, dtype=torch.bool, device=d.device)
    d = d.masked_fill(eye, math.inf)
    n = P * P - P
    s = torch.sort(d.flatten()).values
    med = 0.5 * (s[(n - 1) // 2] + s[n // 2])
    return torch.clamp_min(med**2 / math.log(P), 1e-12)


# (signed integer type of its width, +inf's bit pattern, binary-search rounds)
# of a float dtype: its non-negative values' bits order as those integers, and
# the search runs over [0, +inf]
_BITS = {torch.float32: (torch.int32, 0x7F800000, 31),
         torch.float64: (torch.int64, 0x7FF0000000000000, 63)}


def _kth_smallest_bits(bits: torch.Tensor, k: int, top: int, rounds: int) -> torch.Tensor:
    """Exact k-th smallest (0-based) of non-negative-float bit patterns (as
    signed integers, which order as the floats): a binary search over
    [0, top] with one masked count a round (phlash_tpu/svgd.py:32-53).
    Returns the element's bits, 0-d."""
    lo = torch.zeros((), dtype=bits.dtype, device=bits.device)
    hi = torch.full((), top, dtype=bits.dtype, device=bits.device)
    for _ in range(rounds):
        mid = lo + ((hi - lo) >> 1)
        take_lo = (bits <= mid).sum() >= k + 1  # the k-th value lies in [lo, mid]
        lo, hi = torch.where(take_lo, lo, mid + 1), torch.where(take_lo, mid, hi)
    return lo


def offdiag_median_select(d: torch.Tensor, num_particles: int) -> torch.Tensor:
    """Median of the off-diagonal entries of a symmetric (P, P) distance
    matrix by exact bitwise selection, float32 or float64: bit-identical to
    median_bandwidth's sort and average of the two middle order statistics
    (phlash_tpu/svgd.py:56-76, which takes it on the accelerator in float32
    for speed; here it is a plain version that tests hold to it)."""
    P = num_particles
    itype, top, rounds = _BITS[d.dtype]
    n = P * P - P
    eye = torch.eye(P, dtype=torch.bool, device=d.device)
    bits = d.masked_fill(eye, math.inf).flatten().view(itype)
    k1, k2 = (n - 1) // 2, n // 2
    v1 = _kth_smallest_bits(bits, k1, top, rounds)
    if k2 == k1:
        v2 = v1
    else:
        # rank k2 = k1 + 1: either a duplicate of v1 or the next value up
        nxt = torch.where(bits > v1, bits, torch.full_like(bits, top)).min()
        v2 = torch.where((bits <= v1).sum() >= k2 + 1, v1, nxt)
    f1, f2 = (v.reshape(1).view(d.dtype)[0] for v in (v1, v2))
    return 0.5 * (f1 + f2)


def svgd_direction(flat_particles: torch.Tensor, flat_grads: torch.Tensor,
                   rows: slice = slice(None)) -> torch.Tensor:
    """SVGD update direction for flattened particles (P, D), at the particles
    `rows` (all by default; a rank of a mesh's particle axis takes its
    block: the bandwidth and the sums still run over every particle)."""
    kernels.tally.add("direction_plain")
    P = flat_particles.shape[0]
    diffs = flat_particles[:, None, :] - flat_particles[None, :, :]  # (P, P, D)
    sq = (diffs**2).sum(-1)
    h = median_bandwidth(sq, P)
    K = torch.exp(-sq[rows] / h)
    attract = K @ flat_grads
    repulse = (2.0 / h) * (K @ flat_particles - K.sum(1, keepdim=True) * flat_particles[rows])
    return (attract - repulse) / P


@dataclass(frozen=True)
class AMSGradState:
    mu: torch.Tensor
    nu: torch.Tensor
    nu_max: torch.Tensor
    count: torch.Tensor  # 0-d int64, steps taken


@dataclass(frozen=True)
class AMSGrad:
    "optax.amsgrad(learning_rate) with its defaults b1, b2, eps (eps_root = 0)."

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: torch.Tensor) -> AMSGradState:
        return AMSGradState(mu=torch.zeros_like(params), nu=torch.zeros_like(params),
                            nu_max=torch.zeros_like(params),
                            count=torch.zeros((), dtype=torch.int64, device=params.device))

    def update(self, g: torch.Tensor, state: AMSGradState):
        "(updates to add to the params, new state) for the descent direction g."
        kernels.tally.add("amsgrad_plain")
        mu = (1 - self.b1) * g + self.b1 * state.mu
        nu = (1 - self.b2) * g**2 + self.b2 * state.nu
        count = state.count + 1
        n = count.to(mu.dtype)  # the bias corrections as tensor ops, in the moments' dtype
        mu_hat = mu / (1 - torch.pow(self.b1, n))
        nu_hat = nu / (1 - torch.pow(self.b2, n))
        nu_max = torch.maximum(state.nu_max, nu_hat)
        updates = -self.learning_rate * (mu_hat / (torch.sqrt(nu_max) + self.eps))
        return updates, AMSGradState(mu=mu, nu=nu, nu_max=nu_max, count=count)


def update_plain(x: torch.Tensor, g: torch.Tensor, rows: slice, opt_state: AMSGradState,
                 optimizer: AMSGrad) -> tuple[torch.Tensor, ...]:
    """The update's plain version (S1-S3's, ops/svgd.step_cuda's arguments
    and results): the state tensors (particles, mu, nu, nu_max, count) of
    rows `rows` after one SVGD + amsgrad step from every particle x and
    every gradient g; opt_state holds that block's moments and the count."""
    # a pathological particle can emit inf/nan gradients; zero them so it is
    # carried by the kernel-weighted attraction instead of poisoning the
    # optimizer moments
    g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    phi = svgd_direction(x, g, rows)
    # the optimizer descends; SVGD ascends the density
    updates, o = optimizer.update(-phi, opt_state)
    return x[rows] + updates, o.mu, o.nu, o.nu_max, o.count


@dataclass(frozen=True)
class SVGDState:
    particles: torch.Tensor  # (P, D)
    opt_state: AMSGradState

    def tensors(self) -> tuple[torch.Tensor, ...]:
        "particles, mu, nu, nu_max, count: the whole state, in this order."
        o = self.opt_state
        return self.particles, o.mu, o.nu, o.nu_max, o.count

    @classmethod
    def from_tensors(cls, tensors) -> "SVGDState":
        particles, mu, nu, nu_max, count = tensors
        return cls(particles=particles, opt_state=AMSGradState(mu, nu, nu_max, count))


class SVGD:
    """SVGD: a batched log-density gradient plus amsgrad.

    grad_fn(particles (P, D), **density_kwargs) -> (P, D) gradients of each
    particle's log-density.  With `gather` the state holds one block of the
    cloud (a rank of a mesh's particle axis): gather(particles, grads) ->
    (every particle, every gradient, this block's rows), and the step moves
    the block along its rows of the direction (parallel/mesh.py).  The
    update after the gradients is the hand kernels S1-S3 (ops/svgd.py) on a
    CUDA cloud and the plain version here on a CPU cloud."""

    def __init__(self, grad_fn: Callable, optimizer: AMSGrad, gather: Callable = None):
        self.grad_fn = grad_fn
        self.optimizer = optimizer
        self.gather = gather

    def init(self, particles: torch.Tensor) -> SVGDState:
        return SVGDState(particles=particles, opt_state=self.optimizer.init(particles))

    def step(self, state: SVGDState, **density_kwargs) -> SVGDState:
        grads = self.grad_fn(state.particles, **density_kwargs)
        with torch.no_grad():
            if self.gather is None:
                x, g, rows = state.particles, grads, slice(None)
            else:
                x, g, rows = self.gather(state.particles, grads)
            if x.device.type == "cuda":
                update = kernels.step_cuda
            elif x.device.type == "cpu":
                update = update_plain
            else:
                raise ValueError(f"no SVGD update for device {x.device}")
            return SVGDState.from_tensors(update(x, g, rows, state.opt_state, self.optimizer))
