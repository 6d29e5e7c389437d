"""Numerically careful primitives shared across the coalescent math core.

Port of phlash_tpu/utils/numerics.py:18-52.  The JAX package routes these
through utils/accurate.py because TPU transcendentals are approximate; the
port uses torch's native exp/expm1/log/log1p, which are faithfully rounded on
the CPU and on CUDA without fast-math (tests/test_torch_params.py holds the
float32 assembly against float64).
"""

from __future__ import annotations

import torch


def softplus_inv(y: torch.Tensor) -> torch.Tensor:
    "Inverse of softplus for y > 0: log(exp(y) - 1), stable for large y."
    return y + torch.log1p(-torch.exp(-y))


def softplus(x: torch.Tensor) -> torch.Tensor:
    "log(1 + e^x) = max(x, 0) + log1p(e^-|x|), with no large-x threshold."
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def expm1inv(x: torch.Tensor) -> torch.Tensor:
    """1/expm1(x) without overflow for large x: for x > 10 rewrite as
    -e^-x / expm1(-x).  Both branches see a safe operand, so gradients stay
    finite."""
    big = x > 10.0
    x_lo = torch.where(big, torch.ones_like(x), x)
    return torch.where(big, -torch.exp(-x) / torch.expm1(-x), 1.0 / torch.expm1(x_lo))


def texp_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of a rate-x exponential truncated to the unit interval.

    g(x) = 1/x - 1/expm1(x), with g(0) = 1/2 and g(inf) = 0.  |x| < 0.1
    switches to the cubic Taylor expansion 1/2 - x/12 + x^3/720, where the
    generic form cancels.
    """
    small = torch.abs(x) < 0.1
    x_safe = torch.where(small, torch.ones_like(x), x)
    generic = 1.0 / x_safe - expm1inv(x_safe)
    taylor = 0.5 - x / 12.0 + x**3 / 720.0
    return torch.where(small, taylor, generic)
