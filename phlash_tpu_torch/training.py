"""Construction of the SVGD training program, and fit's call of k steps.

Port of phlash_tpu/training.py:34-243: given a chunk tensor and options,
produce the initial particle cloud, `base_step(state, inds) -> state`, one
SVGD iteration on the minibatch chunks `inds` (S,) (the assembly, the
warm-up filter, the likelihood and their gradient through the kernels, the
SVGD + amsgrad update, all on `device`), and `step`, a `Caller` of
`steps_per_call` iterations.

Minibatch indices are drawn outside the step.  `fit` draws a call's
(k, S) index rows in one torch.randint from its generator (the counterpart
of jax.random.split(key, k)), and `make_multi_step(step, k)` runs k
iterations on those rows.  On the CPU a call is that loop, eagerly.  On
CUDA, `Caller` captures it once per (k, with the held-out ELPD or not) as a
CUDA graph over static buffers and replays it: the counterpart of jax.jit
over lax.scan, one graph launch in place of the ~130 kernel launches that
each iteration issues from Python.

What a step may do, so that its capture replays right: no host sync (no
.item(), float(), bool() or printing of a device value), no copy from the
host (constants are built once per device: size_history._pair_counts,
_W_tensor, params._expand_index), no random draw, and no Python number
that changes from one step to the next (the amsgrad count is a tensor).

With `mesh=` (parallel.make_mesh) the program is one rank's part of a
multi-GPU fit: every rank draws the same initial cloud from the same
generator and keeps its block of particles; it uploads only its block of
chunks; and `base_step` is the sharded SVGD step, whose collectives
(parallel/mesh.py) a CUDA graph captures with the kernels.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from phlash_tpu_torch import profiling
from phlash_tpu_torch.afs import default_afs_transform
from phlash_tpu_torch.kernel import check_backend, get_kernel
from phlash_tpu_torch.kernel_base import upload
from phlash_tpu_torch.model import log_density_batched, log_density_rows
from phlash_tpu_torch.parallel import mesh as comms
from phlash_tpu_torch.params import MCMCParams
from phlash_tpu_torch.svgd import SVGD, AMSGrad, SVGDState
from phlash_tpu_torch.utils import Pattern

logger = logging.getLogger(__name__)


def make_multi_step(step: Callable, k: int) -> Callable:
    """`step` applied to the k rows of a (k, S) index tensor, in order:
    `(state, inds) -> state`.  The counterpart of phlash_tpu's lax.scan
    chain; `Caller` captures it as one CUDA graph."""

    def multi(state: SVGDState, inds: torch.Tensor) -> SVGDState:
        for j in range(k):
            state = step(state, inds[j])
        return state

    return multi


def resolve_steps_per_call(steps_per_call: int | None, device, niter: int) -> int:
    """SVGD iterations per call: explicit, else 10 on CUDA and 1 on the CPU
    (phlash_tpu: 10 on an accelerator, 1 on the CPU); capped at niter."""
    if steps_per_call is None:
        steps_per_call = 10 if torch.device(device).type == "cuda" else 1
    return max(1, min(int(steps_per_call), niter))


def clone_state(state: SVGDState) -> SVGDState:
    "A copy of `state` that no later call changes (a Caller's state is static on CUDA)."
    return SVGDState.from_tensors(t.clone() for t in state.tensors())


def _copy_into(dst: SVGDState, src: SVGDState) -> None:
    for d, s in zip(dst.tensors(), src.tensors()):
        d.copy_(s)


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inds: torch.Tensor  # (k, S) static index rows
    elpd_inds: torch.Tensor | None  # static held-out chunk indices
    elpd: torch.Tensor | None  # 0-d static output
    counts: list  # profiling.since's share of one replay, in the host tallies


class Caller:
    """fit's call: `(state, inds (k, S), elpd_inds=None) -> (state, elpd)`.

    Runs k = len(inds) SVGD iterations of `base_step`, one on each row of
    `inds`.  With `elpd_inds` it then evaluates `elpd(particles, elpd_inds)`
    (the held-out ELPD, a 0-d tensor) on the particles after them, in the
    same call (phlash_tpu fuses it into the jitted call the same way);
    without, elpd is None.

    On the CPU a call runs eagerly (`run`).  On CUDA:
    - the state lives in static buffers, which every replay updates in
      place; the call returns that static state.  A state passed in that is
      not it (the first call, a resumed state) is copied in first.  A caller
      that keeps a state across calls must clone it.
    - the first call of each (k, with ELPD) pair runs one eager iteration
      (and the ELPD) on a copy of the state, on a side stream, so that
      autograd and cuBLAS initialise outside the capture, then captures the
      k iterations and the ELPD as one graph on that stream, into a memory
      pool that all of this Caller's graphs share.  Later calls copy the
      indices into the graph's static buffers and replay it.  The warm-up
      and the capture draw no random numbers (the indices come in), so
      they move neither the trajectory nor any generator.
    - a capture that fails raises; nothing falls back to eager stepping.
    - the host tallies (profiling.Tally: the kernels' launches, the packed
      kernels' work, a mesh's collectives) count what ran on the card: the
      warm-up's counts stay, the capture's are taken back, and every
      replay adds what its capture counted.
    `setup_seconds[(k, with_elpd)]` holds the host time of each graph's
    warm-up and of its capture with instantiation, from the stamps of its
    phlash.capture span.  A call is a phlash.call.launch span (profiling.py).
    """

    def __init__(self, base_step: Callable, elpd: Callable | None = None):
        self.base_step, self.elpd = base_step, elpd
        self.state: SVGDState | None = None  # the static state (CUDA)
        self.graphs: dict[tuple[int, bool], _Graph] = {}
        self.setup_seconds: dict[tuple[int, bool], dict] = {}
        self._pool = self._stream = None

    def run(self, state: SVGDState, inds: torch.Tensor, elpd_inds: torch.Tensor | None = None):
        "The call, eagerly: make_multi_step(base_step, k), then the ELPD."
        state = make_multi_step(self.base_step, len(inds))(state, inds)
        return state, None if elpd_inds is None else self.elpd(state.particles, elpd_inds)

    def __call__(self, state: SVGDState, inds: torch.Tensor, elpd_inds: torch.Tensor | None = None):
        with profiling.call_span("phlash.call.launch"):
            if inds.device.type != "cuda":
                return self.run(state, inds, elpd_inds)
            if self.state is None:
                self.state = clone_state(state)
            elif state is not self.state:
                _copy_into(self.state, state)
            key = (len(inds), elpd_inds is not None)
            if key not in self.graphs:
                self.graphs[key] = self._capture(key, inds, elpd_inds)
            g = self.graphs[key]
            g.inds.copy_(inds)
            if elpd_inds is not None:
                g.elpd_inds.copy_(elpd_inds)
            g.graph.replay()
            profiling.replay(g.counts)
            return self.state, g.elpd

    def _capture(self, key, inds: torch.Tensor, elpd_inds: torch.Tensor | None) -> _Graph:
        dev = inds.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        g = _Graph(graph=torch.cuda.CUDAGraph(), inds=inds.clone(),
                   elpd_inds=None if elpd_inds is None else elpd_inds.clone(),
                   elpd=None if elpd_inds is None else torch.zeros(
                       (), dtype=self.state.particles.dtype, device=dev),
                   counts=[])
        with profiling.span("phlash.capture", key=key) as sp:
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream):
                self.run(clone_state(self.state), g.inds[:1], g.elpd_inds)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter_ns()
            before = profiling.snapshot()
            # thread_local: the checkpoint writer's thread may wait on a CUDA
            # event while this thread captures
            with torch.cuda.graph(g.graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                state, elpd = self.run(self.state, g.inds, g.elpd_inds)
                _copy_into(self.state, state)
                if elpd is not None:
                    g.elpd.copy_(elpd)
            torch.cuda.synchronize(dev)
        g.counts = profiling.since(before)
        profiling.replay(g.counts, -1)
        secs = dict(warmup=(t1 - sp.start) / 1e9, capture=(sp.end - t1) / 1e9)
        sp.attrs.update(warmup_s=secs["warmup"], capture_s=secs["capture"])
        self.setup_seconds[key] = secs
        logger.info("captured a CUDA graph of %d SVGD iterations%s: warm-up %.3f s, "
                    "capture and instantiation %.3f s", key[0], " and the ELPD" if key[1] else "",
                    secs["warmup"], secs["capture"])
        return g


def resolve_minibatch_size(options: dict, n_chunks: int, niter: int) -> int:
    """The minibatch size S: explicit option, else sized so that a run of
    `niter` steps visits each chunk about once (capped at 5)."""
    return options.get("minibatch_size") or max(1, min(5, int(n_chunks / niter)))


@dataclass
class TrainingProgram:
    state: SVGDState
    step: Caller  # (state, inds (k, S), elpd_inds=None) -> (state, elpd); k = steps_per_call
    base_step: Callable  # (state, inds (S,)) -> state: one eager SVGD iteration
    init: MCMCParams  # the center of the initial cloud; unflattens particles
    kern: object  # the likelihood kernel (holds the device-resident chunks)
    warmup: torch.Tensor  # (N, overlap) int8 warm-up prefixes on the device
    afs: torch.Tensor | None
    afs_transform: torch.Tensor | None
    N: int  # number of training chunks
    S: int  # minibatch size
    window_size: int
    mutation_rate: float | None
    steps_per_call: int = 1
    num_particles: int = 0  # the whole cloud's, whatever the mesh
    mesh: object = None  # the DeviceMesh of a sharded program


def batched_grad(init: MCMCParams) -> Callable:
    """grad_fn for SVGD: per-particle gradients of log_density_batched from
    one backward pass of the summed densities (particles are independent)."""

    def grad_fn(flat: torch.Tensor, **kw) -> torch.Tensor:
        x = flat.detach().requires_grad_(True)
        total = log_density_batched(init.unflatten(x), **kw).sum()
        return torch.autograd.grad(total, x)[0]

    return grad_fn


def sharded_grad(init: MCMCParams, chunks: comms.ShardedChunks) -> Callable:
    """grad_fn for SVGD on one rank of a mesh: the minibatch rows fetched
    from their owners, this rank's particle block on its share of them
    (the prior and the AFS term on the chunk axis's first rank only), and
    the gradients summed over the chunk axis (parallel/mesh.py)."""
    mesh = chunks.mesh
    first = mesh.get_local_rank(comms.CHUNK_AXIS) == 0

    def grad_fn(flat: torch.Tensor, c, inds: torch.Tensor, kern, afs, afs_transform=None):
        warm, rows = chunks.fetch(inds)
        mine = comms.share(mesh, len(inds))
        x = flat.detach().requires_grad_(True)
        total = log_density_rows(init.unflatten(x), c, warm[mine], rows[mine], kern, afs,
                                 afs_transform, prior_and_afs=first)
        g = torch.autograd.grad(total.sum(), x)[0] if total.requires_grad else torch.zeros_like(x)
        return comms.reduce_density(mesh, g, total.detach())

    return grad_fn


@profiling.spanned("phlash.start.build")
def build_training(chunks: np.ndarray, afs: np.ndarray | None, *, window_size: int,
                   overlap: int, options: dict, device: torch.device,
                   generator: torch.Generator, kernel_backend: str = None,
                   mesh=None) -> TrainingProgram:
    """Assemble particles, kernel and the step functions from chunked data.
    kernel_backend: "smc" (default), "packed" (overlap 0 only), "dense" or
    "scan".  `generator` draws the initial cloud; `fit` draws the minibatch
    indices (see the module docstring).  The options of phlash_tpu's
    build_training that shape the program: truth (sets mutation_rate),
    init (the cloud's centre, an MCMCParams), afs_transform,
    double_precision_params (a float64 cloud and assembly), and
    double_precision and kernel_seg_len (see kernel.py).  mesh: a
    parallel.make_mesh DeviceMesh (see the module docstring); its particle
    axis must divide num_particles."""
    double_precision = options.get("double_precision", False)
    seg_len = options.get("kernel_seg_len")
    kernel_backend = check_backend(kernel_backend, overlap, double_precision, seg_len)
    niter = options.get("niter", 1000)
    mutation_rate = options.get("mutation_rate")
    truth = options.get("truth")
    if truth is not None:
        if mutation_rate:
            raise ValueError("mutation rate is already known from truth")
        mutation_rate = truth.theta
    # the particle cloud and the assembly run in float32, or in float64 with
    # double_precision_params=True
    dtype = torch.float64 if options.get("double_precision_params", False) else torch.float32

    afs_transform = options.get("afs_transform")
    if afs_transform is None and afs is not None:
        afs_transform = default_afs_transform(afs)
    if afs_transform is not None:
        afs_transform = torch.as_tensor(afs_transform, dtype=dtype, device=device)
    if afs is not None:
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

    init = options.get("init")
    if init is None:
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
        )
    elif not isinstance(init, MCMCParams):
        raise TypeError(f"init must be a phlash_tpu_torch.params.MCMCParams, got {type(init)}")
    init = init.to(dtype=dtype, device=device)

    # particle cloud: Gaussian around the init, covariance sigma * I
    num_particles = options.get("num_particles", 500)
    x0 = init.flatten()
    noise = torch.randn(num_particles, x0.shape[-1], generator=generator, dtype=dtype,
                        device=device)
    particles = x0 + options.get("sigma", 1.0) ** 0.5 * noise

    optimizer = AMSGrad(learning_rate=options.get("learning_rate", 0.1))
    warmup_host, data_host = np.split(chunks, [overlap], axis=1)

    def make_kernel(body: np.ndarray):
        return get_kernel(M=init.M, data=np.ascontiguousarray(body), device=device,
                          backend=kernel_backend, double_precision=double_precision,
                          seg_len=seg_len)

    # unbiased minibatch gradients: HMM term scaled by N / S
    weights = (1.0, N / S, 1.0)

    if mesh is None:
        svgd = SVGD(batched_grad(init), optimizer)
        state = svgd.init(particles)
        warmup_dev = upload(np.ascontiguousarray(warmup_host), device)
        kern = make_kernel(data_host)

        def one_step(state: SVGDState, inds: torch.Tensor) -> SVGDState:
            "One SVGD step on the minibatch chunks `inds` (S,), drawn with replacement."
            return svgd.step(state, c=weights, inds=inds, warmup=warmup_dev[inds], kern=kern,
                             afs=afs, afs_transform=afs_transform)
    else:
        if device.type != mesh.device_type:
            raise ValueError(f"a {mesh.device_type} mesh cannot fit on device {device}")
        rows = comms.particle_sharding(mesh, num_particles)
        sharded = comms.shard_chunks(mesh, warmup_host, data_host, make_kernel)
        svgd = SVGD(sharded_grad(init, sharded), optimizer,
                    gather=lambda x, g: comms.gather_cloud(mesh, x, g))
        state = svgd.init(particles[rows].clone())
        warmup_dev, kern = sharded.warmup, sharded.kern

        def one_step(state: SVGDState, inds: torch.Tensor) -> SVGDState:
            "One sharded SVGD step on the minibatch chunks `inds` (S,), the same on every rank."
            return svgd.step(state, c=weights, inds=inds, kern=kern, afs=afs,
                             afs_transform=afs_transform)

    return TrainingProgram(
        state=state, step=Caller(one_step), base_step=one_step, init=init, kern=kern,
        warmup=warmup_dev, afs=afs, afs_transform=afs_transform, N=N, S=S,
        window_size=window_size, mutation_rate=mutation_rate,
        steps_per_call=resolve_steps_per_call(options.get("steps_per_call"), device, niter),
        num_particles=num_particles, mesh=mesh,
    )
