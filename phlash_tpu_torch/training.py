"""Construction of the SVGD training program.

Port of phlash_tpu/training.py:82-243 with one SVGD iteration per call: given
a chunk tensor and options, produce the initial particle cloud and a
`step(state) -> state` that draws a minibatch, filters its warmup prefixes,
takes the likelihood and its gradient through the kernel pair and applies
the SVGD + amsgrad update, all on `device`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from phlash_tpu_torch.afs import default_afs_transform
from phlash_tpu_torch.kernel import check_backend, get_kernel
from phlash_tpu_torch.model import log_density_batched
from phlash_tpu_torch.params import MCMCParams
from phlash_tpu_torch.svgd import SVGD, AMSGrad, SVGDState
from phlash_tpu_torch.utils import Pattern

logger = logging.getLogger(__name__)


def resolve_minibatch_size(options: dict, n_chunks: int, niter: int) -> int:
    """The minibatch size S: explicit option, else sized so that a run of
    `niter` steps visits each chunk about once (capped at 5)."""
    return options.get("minibatch_size") or max(1, min(5, int(n_chunks / niter)))


@dataclass
class TrainingProgram:
    state: SVGDState
    step: Callable  # (state) -> state: one SVGD iteration on a fresh minibatch
    init: MCMCParams  # the center of the initial cloud; unflattens particles
    afs_transform: torch.Tensor | None
    S: int  # minibatch size
    window_size: int
    mutation_rate: float | None


def batched_grad(init: MCMCParams) -> Callable:
    """grad_fn for SVGD: per-particle gradients of log_density_batched from
    one backward pass of the summed densities (particles are independent)."""

    def grad_fn(flat: torch.Tensor, **kw) -> torch.Tensor:
        x = flat.detach().requires_grad_(True)
        total = log_density_batched(init.unflatten(x), **kw).sum()
        return torch.autograd.grad(total, x)[0]

    return grad_fn


def build_training(chunks: np.ndarray, afs: np.ndarray | None, *, window_size: int,
                   overlap: int, options: dict, device: torch.device,
                   generator: torch.Generator, kernel_backend: str = None) -> TrainingProgram:
    """Assemble particles, kernel and the one-step function from chunked data.
    kernel_backend: "smc" (default), "packed" (overlap 0 only) or "dense"."""
    kernel_backend = check_backend(kernel_backend, overlap)
    niter = options.get("niter", 1000)
    mutation_rate = options.get("mutation_rate")
    dtype = torch.float32  # the particle cloud and the assembly run in float32

    afs_transform = None
    if afs is not None:
        afs_transform = torch.as_tensor(default_afs_transform(afs), dtype=dtype, device=device)
        afs = torch.as_tensor(np.asarray(afs), dtype=dtype, device=device)

    S = resolve_minibatch_size(options, len(chunks), niter)
    N = len(chunks)

    # Watterson-style estimate of the scaled mutation rate
    body = chunks[:, overlap:]
    observed = body[body > -1]
    if observed.size == 0 or observed.sum() == 0:
        raise ValueError(
            "the data contain no observed heterozygous sites (all columns missing or "
            "homozygous); cannot estimate theta — pass theta= explicitly if this is intended"
        )
    watterson = observed.mean() / window_size
    theta = options.get("theta", watterson)
    logger.info("scaled mutation rate theta=%.4g", theta)

    t1, tM = options.get("t1"), options.get("tM")
    if mutation_rate is not None:
        N0 = theta / mutation_rate
        t1 = 1e1 / 2 / N0 if t1 is None else t1
        tM = 1e6 / 2 / N0 if tM is None else tM
    t1 = 1e-4 if t1 is None else t1
    tM = 15.0 if tM is None else tM
    rho = options.get("rho_over_theta", 1.0) * theta
    pattern = options.get("pattern", "14*1+1*2")
    # assembled in float64 like phlash_tpu's init, then cast to the cloud's dtype
    init = MCMCParams.from_linear(
        pattern=pattern,
        rho=rho * window_size,
        t1=t1,
        tM=tM,
        c=np.ones(len(Pattern(pattern))),
        theta=theta * window_size,
        alpha=options.get("alpha", 0.0),
        beta=options.get("beta", 0.0),
    ).to(dtype=dtype, device=device)

    # particle cloud: Gaussian around the init, covariance sigma * I
    num_particles = options.get("num_particles", 500)
    x0 = init.flatten()
    noise = torch.randn(num_particles, x0.shape[-1], generator=generator, dtype=dtype,
                        device=device)
    particles = x0 + options.get("sigma", 1.0) ** 0.5 * noise

    svgd = SVGD(batched_grad(init), AMSGrad(learning_rate=options.get("learning_rate", 0.1)))
    state = svgd.init(particles)

    warmup_host, data_host = np.split(chunks, [overlap], axis=1)
    warmup_dev = torch.as_tensor(np.ascontiguousarray(warmup_host), dtype=torch.int8,
                                 device=device)
    kern = get_kernel(M=init.M, data=np.ascontiguousarray(data_host), device=device,
                      backend=kernel_backend)

    # unbiased minibatch gradients: HMM term scaled by N / S
    weights = (1.0, N / S, 1.0)

    def one_step(state: SVGDState) -> SVGDState:
        "Draw S chunk indices (with replacement) and take one SVGD step."
        inds = torch.randint(N, (S,), generator=generator, device=device)
        return svgd.step(state, c=weights, inds=inds, warmup=warmup_dev[inds], kern=kern,
                         afs=afs, afs_transform=afs_transform)

    return TrainingProgram(
        state=state, step=one_step, init=init, afs_transform=afs_transform, S=S,
        window_size=window_size, mutation_rate=mutation_rate,
    )
