"""The SVGD update's plain reference: RBF kernel with the median bandwidth, then amsgrad.

A frozen copy of the plain arithmetic of phlash_tpu_torch/svgd.py
(`median_bandwidth`, `svgd_direction`, `AMSGrad.update`: optax.amsgrad's
rule), written on tensors.  `half=True` plants a fault: the direction's
mean over the particles j is taken over the first half of them only.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.hmm import Arith

B1, B2, EPS = 0.9, 0.999, 1e-8


def bandwidth(sq: torch.Tensor) -> torch.Tensor:
    "med^2 / log P over the strict off-diagonal distances, floored at 1e-12."
    P = sq.shape[0]
    d = torch.sqrt(sq).masked_fill(torch.eye(P, dtype=torch.bool, device=sq.device), math.inf)
    n = P * P - P
    s = torch.sort(d.flatten()).values
    med = 0.5 * (s[(n - 1) // 2] + s[n // 2])
    return torch.clamp_min(med**2 / math.log(P), 1e-12)


def direction(x: torch.Tensor, g: torch.Tensor, ar: Arith, half: bool = False) -> torch.Tensor:
    "phi_i = (1/P) sum_j [K(x_j, x_i) g_j + grad_{x_j} K(x_j, x_i)]."
    P = x.shape[0]
    sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    h = bandwidth(sq)
    K = torch.exp(-sq / h)
    n = P
    if half:
        n = P // 2
        K, xs, gs = K[:, :n], x[:n], g[:n]
    else:
        xs, gs = x, g
    attract = ar.mm(K, gs)
    repulse = (2.0 / h) * (ar.mm(K, xs) - K.sum(1, keepdim=True) * x)
    return (attract - repulse) / n


def amsgrad(phi: torch.Tensor, state: dict, lr: float) -> torch.Tensor:
    "The step amsgrad takes to descend -phi; updates `state` (mu, nu, nu_max, count)."
    g = -phi
    state["mu"] = (1 - B1) * g + B1 * state["mu"]
    state["nu"] = (1 - B2) * g**2 + B2 * state["nu"]
    state["count"] += 1
    n = torch.tensor(float(state["count"]), dtype=phi.dtype, device=phi.device)
    mu_hat = state["mu"] / (1 - torch.pow(B1, n))
    nu_hat = state["nu"] / (1 - torch.pow(B2, n))
    state["nu_max"] = torch.maximum(state["nu_max"], nu_hat)
    return -lr * (mu_hat / (torch.sqrt(state["nu_max"]) + EPS))


def init_state(x: torch.Tensor) -> dict:
    z = torch.zeros_like(x)
    return dict(mu=z, nu=z.clone(), nu_max=z.clone(), count=0)
