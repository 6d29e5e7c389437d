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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch


def median_bandwidth(sq_dists: torch.Tensor, num_particles: int) -> torch.Tensor:
    """h = med^2 / log(P), floored at 1e-12, where med is the median of the
    strict lower triangle of pairwise distances.  Every off-diagonal value
    appears twice in the full matrix, which preserves the median, so the
    diagonal is masked to +inf and the two middle order statistics of the
    sorted matrix are averaged."""
    P = num_particles
    d = torch.sqrt(sq_dists)
    eye = torch.eye(P, dtype=torch.bool, device=d.device)
    d = d.masked_fill(eye, math.inf)
    n = P * P - P
    s = torch.sort(d.flatten()).values
    med = 0.5 * (s[(n - 1) // 2] + s[n // 2])
    return torch.clamp_min(med**2 / math.log(P), 1e-12)


def svgd_direction(flat_particles: torch.Tensor, flat_grads: torch.Tensor,
                   rows: slice = slice(None)) -> torch.Tensor:
    """SVGD update direction for flattened particles (P, D), at the particles
    `rows` (all by default; a rank of a mesh's particle axis takes its
    block: the bandwidth and the sums still run over every particle)."""
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
        mu = (1 - self.b1) * g + self.b1 * state.mu
        nu = (1 - self.b2) * g**2 + self.b2 * state.nu
        count = state.count + 1
        n = count.to(mu.dtype)  # the bias corrections as tensor ops, in the moments' dtype
        mu_hat = mu / (1 - torch.pow(self.b1, n))
        nu_hat = nu / (1 - torch.pow(self.b2, n))
        nu_max = torch.maximum(state.nu_max, nu_hat)
        updates = -self.learning_rate * (mu_hat / (torch.sqrt(nu_max) + self.eps))
        return updates, AMSGradState(mu=mu, nu=nu, nu_max=nu_max, count=count)


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
    the block along its rows of the direction (parallel/mesh.py)."""

    def __init__(self, grad_fn: Callable, optimizer: AMSGrad, gather: Callable = None):
        self.grad_fn = grad_fn
        self.optimizer = optimizer
        self.gather = gather

    def init(self, particles: torch.Tensor) -> SVGDState:
        return SVGDState(particles=particles, opt_state=self.optimizer.init(particles))

    def step(self, state: SVGDState, **density_kwargs) -> SVGDState:
        grads = self.grad_fn(state.particles, **density_kwargs)
        with torch.no_grad():
            # a pathological particle can emit inf/nan gradients; zero them so
            # it is carried by the kernel-weighted attraction instead of
            # poisoning the optimizer moments
            grads = torch.where(torch.isfinite(grads), grads, torch.zeros_like(grads))
            if self.gather is None:
                phi = svgd_direction(state.particles, grads)
            else:
                phi = svgd_direction(*self.gather(state.particles, grads))
            # the optimizer descends; SVGD ascends the density
            updates, opt_state = self.optimizer.update(-phi, state.opt_state)
            return SVGDState(particles=state.particles + updates, opt_state=opt_state)
