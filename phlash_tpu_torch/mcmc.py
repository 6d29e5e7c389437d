"""SVGD posterior sampling: `fit(data, test_data, **options)`.

Port of phlash_tpu/mcmc.py:66-413 for one device and one SVGD iteration per
call: the chunk cap, the iteration loop, the periodic finiteness check,
the held-out ELPD (an exponential moving average over evaluations every 10
iterations, with `elpd_cutoff` iterations of patience) and the return of
the best-ELPD particles (or the last ones with `return_final=True`).

Options with the JAX defaults: niter, num_particles, window_size, overlap,
chunk_size, minibatch_size, learning_rate, sigma, theta, mutation_rate,
pattern, t1, tM, rho_over_theta, alpha, beta, elpd_cutoff, elpd_samples,
return_final.  New in the port: device (default "cuda"; no
card means an error, never a CPU fallback), seed (seeds the
torch.Generator) and kernel_backend, the likelihood algorithm: "smc" (the
default; phlash_tpu's "pallas"), "packed" (phlash_tpu's "pallas_mxu"; needs
overlap=0) or "dense" (phlash_tpu's "dense"); see kernel.py.  The device
decides between the hand CUDA kernels and their plain versions.
Options of phlash_tpu.fit that this port does not implement raise
NotImplementedError when set.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from phlash_tpu_torch.data import RawContig, chunk_het_matrix, init_mcmc_data
from phlash_tpu_torch.kernel import check_backend, get_kernel, resolve_device
from phlash_tpu_torch.model import log_density_batched
from phlash_tpu_torch.size_history import DemographicModel, SizeHistory
from phlash_tpu_torch.training import TrainingProgram, build_training, resolve_minibatch_size

logger = logging.getLogger(__name__)

_OPTIONS = {
    "niter", "num_particles", "window_size", "overlap", "chunk_size", "minibatch_size",
    "learning_rate", "sigma", "theta", "mutation_rate", "pattern", "t1", "tM",
    "rho_over_theta", "alpha", "beta", "elpd_cutoff", "elpd_samples", "return_final",
}
# phlash_tpu.fit options without a counterpart here, with the value that
# means "off" (which is accepted)
_NOT_IMPLEMENTED = {
    "checkpoint_path": None, "save_every": None, "mesh": None, "steps_per_call": 1,
    "kernel_seg_len": None, "callback": None, "double_precision": False,
    "double_precision_params": False, "truth": None, "key": None, "num_workers": 1,
    "max_samples": None, "afs_transform": None, "init": None, "check_every": None,
    "progress": False,
}
CHECK_EVERY = 10  # iterations between finiteness checks (each one syncs the device)
MAX_SAMPLES = 20  # held-out rows used for the ELPD (phlash_tpu's max_samples default)


def _check_options(options: dict) -> None:
    for k, v in options.items():
        if k in _OPTIONS:
            continue
        if k in _NOT_IMPLEMENTED:
            off = _NOT_IMPLEMENTED[k]
            if v is None or (isinstance(v, (bool, int)) and v == off):
                continue
            hint = " (use seed=)" if k == "key" else ""
            raise NotImplementedError(f"fit option {k}={v!r} is not implemented{hint}")
        raise TypeError(f"fit got an unknown option {k!r}")


def _models(prog: TrainingProgram, particles: torch.Tensor) -> list[DemographicModel]:
    "Particles as demographic models in per-window-base units (and generations)."
    with torch.no_grad():
        dm = prog.init.unflatten(particles).to_dm()
    dm = DemographicModel(eta=dm.eta, theta=dm.theta / prog.window_size,
                          rho=dm.rho / prog.window_size)
    if prog.mutation_rate:
        dm = dm.rescale(prog.mutation_rate)
    t, c, rho = (x.detach().cpu() for x in (dm.eta.t, dm.eta.c, dm.rho))
    return [
        DemographicModel(eta=SizeHistory(t=t[k], c=c[k]), theta=dm.theta, rho=float(rho[k]))
        for k in range(t.shape[0])
    ]


def fit(data: list[RawContig], test_data: RawContig = None, *, device="cuda", seed: int = 1,
        kernel_backend: str = None, **options) -> list[DemographicModel]:
    """Sample demographic models from the posterior.

    Returns one DemographicModel per particle, rescaled to per-base-pair
    rates (and to generations when mutation_rate is given).  With
    `test_data`, the particles of the iteration with the best held-out ELPD
    are returned unless `return_final=True`.
    """
    _check_options(options)
    kernel_backend = check_backend(kernel_backend, options.get("overlap", 500))
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    niter = options.get("niter", 1000)
    window_size = options.get("window_size", 100)
    overlap = options.get("overlap", 500)

    afs, chunks = init_mcmc_data(data, window_size, overlap, options.get("chunk_size"))
    del data

    # cap the device-resident data at what the run can visit
    S_opt = resolve_minibatch_size(options, len(chunks), niter)
    if len(chunks) > 5 * S_opt * niter:
        host_gen = torch.Generator().manual_seed(seed)
        sel = torch.randperm(len(chunks), generator=host_gen)[: 5 * S_opt * niter].numpy()
        logger.debug("downsampling chunks %d -> %d", len(chunks), len(sel))
        chunks = chunks[sel]
    options = dict(options, minibatch_size=S_opt)

    prog = build_training(chunks, afs, window_size=window_size, overlap=overlap,
                          options=options, device=dev, generator=gen,
                          kernel_backend=kernel_backend)
    state = prog.state

    elpd_cutoff = options.get("elpd_cutoff", 100)
    if test_data is not None:
        d = test_data.get_data(window_size)
        test_afs = None
        if d["afs"] is not None:
            test_afs = torch.as_tensor(np.asarray(d["afs"]), dtype=torch.float32, device=dev)
        het = d["het_matrix"][:MAX_SAMPLES]
        # chunk the held-out rows like the training data; each evaluation
        # visits a fresh random subset of `elpd_samples` chunks
        span = int(chunks.shape[-1])
        test_chunks = chunk_het_matrix(het, overlap=overlap, chunk_size=span - overlap)
        N_test = len(test_chunks)
        S_elpd = min(N_test, int(options.get("elpd_samples", max(prog.S, 4))))
        test_kern = get_kernel(M=prog.init.M, data=np.ascontiguousarray(test_chunks[:, overlap:]),
                               device=dev, backend=kernel_backend)
        test_warmup = torch.as_tensor(np.ascontiguousarray(test_chunks[:, :overlap]),
                                      dtype=torch.int8, device=dev)
        test_T = None
        if test_afs is not None and prog.afs_transform is not None:
            if prog.afs_transform.shape[1] == len(test_afs):
                test_T = prog.afs_transform

        def elpd(particles: torch.Tensor) -> float:
            if S_elpd == N_test:
                inds = torch.arange(N_test, device=dev)
            else:
                inds = torch.randperm(N_test, generator=gen, device=dev)[:S_elpd]
            with torch.no_grad():  # forward kernel only, no residuals
                return float(log_density_batched(
                    prog.init.unflatten(particles), c=(0.0, 1.0, 1.0), inds=inds,
                    warmup=test_warmup[inds], kern=test_kern, afs=test_afs,
                    afs_transform=test_T,
                ).mean())

    ema, best = None, None  # best = (iteration, ema, particles)
    next_check = next_elpd = 0
    for i in range(niter):
        new_state = prog.step(state)
        if i >= next_check or i + 1 >= niter:
            next_check = i + CHECK_EVERY
            if not bool(torch.isfinite(new_state.particles).all()):
                raise RuntimeError(f"non-finite particles at iteration {i}")
        state = new_state
        if test_data is not None and i >= next_elpd:
            next_elpd = i + 10
            e = elpd(state.particles)
            ema = e if ema is None else 0.9 * ema + 0.1 * e
            if best is None or ema > best[1]:
                best = (i, ema, state.particles)
            if i - best[0] > elpd_cutoff:
                logger.info("ELPD has not improved in %d iterations; stopping early", elpd_cutoff)
                break
    particles = state.particles
    if best is not None and not options.get("return_final", False):
        logger.info("returning best-ELPD state from iteration %d", best[0])
        particles = best[2]
    return _models(prog, particles)
