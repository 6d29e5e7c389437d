"""The (p, d) device mesh of a multi-GPU fit, and its collectives.

Port of phlash_tpu/parallel/mesh.py:13-104 to torch.distributed.  JAX runs
one program over a mesh and lets XLA insert the collectives; here every
rank is a process that runs the fit on its own device, and the collectives
are written out.  The mesh has two axes:

    "p"  the SVGD particles: rank (i, j) holds the i-th block of rows of the
         particle cloud and of the amsgrad moments (the count is
         replicated);
    "d"  the genome chunks: rank (i, j) uploads only the j-th block of rows
         of the chunk tensor (and of the held-out chunks), so the data a
         device holds shrinks with the d axis.

What crosses devices in one SVGD iteration (training.build_training with
mesh=, svgd.SVGD with a gather):
1. `fetch`: every rank draws the same S chunk indices from the same
   generator; the S rows (warm-up prefix and body, int8) reach every rank
   of the d group by one all-reduce in which the owner of a row contributes
   it and the others zeros.  Nothing proportional to the chunk tensor moves.
2. rank (i, j) runs its particle block on its share (`share`) of the S
   chunks through the hand kernels; the per-particle densities and their
   gradients are summed over d by one all-reduce.  The prior and the AFS
   term are added on the d rank 0 only, so once.
3. the SVGD direction needs every particle and gradient: one all-gather
   over p of P x 2D floats.  With slices (nodes) laid outermost on p, this
   is the only traffic between them (docs/DESIGN.md:305-312).
4. each rank applies amsgrad to its block.

Every collective goes through `_all_reduce` / `_all_gather`, which count
its calls and bytes by "op/axis/what" in `tally` (`counts`, `reset_counts`,
`add_counts`, as ops/smc.py counts kernel launches); a CUDA graph replay
adds what its capture counted (training.Caller).  The tally also adds the
calls to the fit's counter `collectives` (profiling.count), so that a span
of the fit counts the collectives made inside it.  A collective issued on
the host outside a CUDA graph's capture (on the CPU every one; on CUDA the
read-back's and the checkpoint's gathers, the finiteness check, and a
graph's eager warm-up) is also a call span `phlash.mesh.collective`
(profiling.call_span: recorded while torch's profiler records), whose host
time is the call's, which on NCCL is its enqueue.  One a graph captures
runs inside the graph's replay and has no span.  NCCL runs the collectives
on CUDA, gloo on the CPU; nothing falls back from one to the other.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from phlash_tpu_torch import profiling
from phlash_tpu_torch.kernel_base import upload

PARTICLE_AXIS = "p"
CHUNK_AXIS = "d"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _init_process_group(device_type: str, n_devices: int | None,
                        timeout: datetime.timedelta | None) -> None:
    """The default process group: from torchrun's environment, or, with
    none of it set and one device, a single rank over a local store."""
    backend = BACKENDS[device_type]
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    elif not any(k in os.environ for k in _TORCHRUN_ENV) and n_devices in (None, 1):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    else:
        raise RuntimeError(
            f"make_mesh({n_devices}): no process group and no torchrun environment; run the "
            "script under `torchrun --nproc-per-node N`, or call "
            "torch.distributed.init_process_group first")


def make_mesh(n_devices: int = None, particle_axis: int = None, n_slices: int = 1,
              device_type: str = "cuda", timeout: datetime.timedelta = None) -> DeviceMesh:
    """A (p, d) DeviceMesh over the n_devices ranks of the default process
    group, with mesh_dim_names ("p", "d").

    The shape rules are phlash_tpu's: the particle axis gets n // 2 devices
    for n >= 4 and n otherwise, the chunk axis the rest; the axes must tile
    n.  With n_slices > 1 (nodes of a multi-node run) the slices lie
    outermost on p (ranks are numbered node by node, as torchrun numbers
    them), so only p-axis traffic crosses them; n_slices must divide p.

    The default process group is made here if there is none: from
    torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_* (so
    `fit(mesh=make_mesh())` runs under `torchrun --nproc-per-node N`), or,
    without them and with one device, as a single rank over a local store
    (so it runs in a plain `python` call too).  NCCL on "cuda", gloo on
    "cpu".  On CUDA each rank takes the device LOCAL_RANK (default: its
    rank modulo the devices of the host).  n_devices must equal the world
    size."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda') but no CUDA device is available")
    if not dist.is_initialized():
        _init_process_group(device_type, n_devices, timeout)
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise RuntimeError(f"the process group runs {backend!r}; a {device_type} mesh needs "
                           f"{BACKENDS[device_type]!r}")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh({n}) in a process group of world size {world}; "
                         "n_devices must equal the world size")
    if particle_axis is None:
        particle_axis = n // 2 if n >= 4 else n
    if particle_axis < 1 or n % particle_axis:
        raise ValueError(f"mesh axes must tile the device count: {n} devices, particle axis "
                         f"{particle_axis}")
    if n_slices < 1 or particle_axis % n_slices:
        raise ValueError(f"the particle axis ({particle_axis}) must be divisible by the slice "
                         f"count ({n_slices})")
    if device_type == "cuda":
        rank = dist.get_rank()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    return init_device_mesh(device_type, (particle_axis, n // particle_axis),
                            mesh_dim_names=(PARTICLE_AXIS, CHUNK_AXIS))


def _block(n: int, k: int, parts: int) -> slice:
    "The k-th of `parts` contiguous blocks of n rows (sizes differ by at most one)."
    return slice(n * k // parts, n * (k + 1) // parts)


def particle_sharding(mesh: DeviceMesh, n: int) -> slice:
    """This rank's rows of an (n, ...) particle-batched tensor: its block on
    the p axis.  n must be a multiple of p (a cloud is not padded)."""
    p = mesh.size(0)
    if n % p:
        raise ValueError(f"{n} particles do not divide over the mesh's particle axis of {p}")
    return _block(n, mesh.get_local_rank(PARTICLE_AXIS), p)


def chunk_sharding(mesh: DeviceMesh, n: int) -> slice:
    "This rank's rows of the (n, L) chunk tensor: its block on the d axis."
    return _block(n, mesh.get_local_rank(CHUNK_AXIS), mesh.size(1))


def replicated(mesh: DeviceMesh, n: int) -> slice:
    "Every row: a replicated tensor."
    return slice(0, n)


def share(mesh: DeviceMesh, S: int) -> slice:
    "This rank's share of a minibatch's S chunks: its block on the d axis."
    return _block(S, mesh.get_local_rank(CHUNK_AXIS), mesh.size(1))


# -- counted collectives ------------------------------------------------------

class _Collectives(profiling.Tally):
    """Collectives run since the last reset: "op/axis/what" -> calls and
    "op/axis/what/bytes" -> the bytes each rank put in (summed); the calls
    it adds also go to the fit's counter `collectives`."""

    __slots__ = ()

    def add_counts(self, n: dict) -> None:
        super().add_counts(n)
        calls = sum(v for k, v in n.items() if not k.endswith("/bytes"))
        if calls:
            profiling.count("collectives", calls)


tally = _Collectives()
counts, reset_counts, add_counts = tally.counts, tally.reset, tally.add_counts


def _count(key: str, t: torch.Tensor) -> None:
    tally.add_counts({key: 1, key + "/bytes": t.numel() * t.element_size()})


def collectives(c: dict = None) -> dict:
    "{'op/axis/what': (calls, bytes per call)} of counts() (or of `c`)."
    c = counts() if c is None else c
    return {k: (v, c[k + "/bytes"] // max(v, 1)) for k, v in c.items()
            if not k.endswith("/bytes")}


def _group(mesh: DeviceMesh, axis: str | None):
    return None if axis is None else mesh.get_group(axis)


def _span(t: torch.Tensor):
    "The span of a collective on `t` issued on the host (none while a CUDA graph captures it)."
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        return contextlib.nullcontext()
    return profiling.call_span("phlash.mesh.collective")


def _all_reduce(t: torch.Tensor, mesh: DeviceMesh, axis: str | None, what: str) -> torch.Tensor:
    "Sum in place over `axis` (None: every rank)."
    _count(f"all_reduce/{axis or 'world'}/{what}", t)
    with _span(t):
        dist.all_reduce(t, group=_group(mesh, axis))
    return t


_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str, what: str) -> torch.Tensor:
    "The rows of every rank of `axis`, in rank order: (size * n, ...)."
    _count(f"all_gather/{axis}/{what}", t)
    t = t.contiguous()
    out = t.new_empty((mesh.size(mesh.mesh_dim_names.index(axis)) * t.shape[0], *t.shape[1:]))
    with _span(t):
        _gather_into(out, t, group=_group(mesh, axis))
    return out


# -- the sharded pieces of the training program ------------------------------


@dataclass
class ShardedChunks:
    """This rank's block of a chunk tensor: the warm-up prefixes `warmup`
    (n, overlap) and the kernel's body rows `kern.data` (n, L'), rows
    [lo, lo + n) of all the chunks; `what` names its fetches in the counts."""

    mesh: DeviceMesh
    warmup: torch.Tensor
    kern: object
    lo: int
    what: str = "rows"

    def fetch(self, inds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(warm-up rows (S, overlap), body rows (S, L')) of the chunks
        `inds` (S,), on every rank of the d group: each row from the rank
        that holds it, by one all-reduce over d."""
        body = self.kern.data
        n = body.shape[0]
        local = inds - self.lo
        mine = (local >= 0) & (local < n)
        local = local.clamp(0, max(n - 1, 0))
        rows = torch.cat([self.warmup[local], body[local]], 1) if n else torch.zeros(
            (len(inds), self.warmup.shape[1] + body.shape[1]), dtype=body.dtype,
            device=body.device)
        rows = rows * mine[:, None].to(rows.dtype)
        _all_reduce(rows, self.mesh, CHUNK_AXIS, self.what)
        return rows[:, : self.warmup.shape[1]], rows[:, self.warmup.shape[1]:]


def shard_chunks(mesh: DeviceMesh, warmup, body, make_kernel,
                 what: str = "rows") -> ShardedChunks:
    """Upload only this rank's d block of the (N, overlap) warm-up prefixes
    and (N, L) bodies (host arrays); make_kernel(rows) builds the kernel on
    the block of bodies."""
    rows = chunk_sharding(mesh, len(body))
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    warm = upload(warmup[rows], dev)
    return ShardedChunks(mesh=mesh, warmup=warm, kern=make_kernel(body[rows]), lo=rows.start,
                         what=what)


def reduce_density(mesh: DeviceMesh, grads: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """The gradients (B, D) summed over d with the densities (B,) (one
    all-reduce); a particle whose summed density is not finite gets zero
    gradients, as the unsharded step's masked density gives it."""
    both = _all_reduce(torch.cat([grads, total[:, None].to(grads.dtype)], 1), mesh, CHUNK_AXIS,
                       "density")
    grads, total = both[:, :-1], both[:, -1]
    return torch.where(torch.isfinite(total)[:, None], grads, torch.zeros_like(grads))


def reduce_elpd(mesh: DeviceMesh, total: torch.Tensor) -> torch.Tensor:
    """The held-out ELPD, the mean over every particle of the densities this
    rank computed for its block on its share of the chunks (B,): summed over
    d, -inf where not finite, gathered over p; the same 0-d value on every
    rank."""
    total = _all_reduce(total.clone(), mesh, CHUNK_AXIS, "elpd")
    total = torch.where(torch.isfinite(total), total, torch.full_like(total, -math.inf))
    return gather_rows(mesh, total, "elpd").mean()


def gather_cloud(mesh: DeviceMesh, particles: torch.Tensor, grads: torch.Tensor):
    """(every particle (P, D), every gradient (P, D), this rank's rows):
    one all-gather over p."""
    D = particles.shape[1]
    both = _all_gather(torch.cat([particles, grads], 1), mesh, PARTICLE_AXIS, "cloud")
    return both[:, :D], both[:, D:], particle_sharding(mesh, both.shape[0])


def gather_rows(mesh: DeviceMesh, t: torch.Tensor, what: str) -> torch.Tensor:
    "A p-sharded tensor (B_i, ...) whole, (P, ...), on every rank: one all-gather over p."
    return _all_gather(t, mesh, PARTICLE_AXIS, what)


def all_finite(mesh: DeviceMesh, t: torch.Tensor) -> bool:
    "Whether every rank's `t` is finite (one all-reduce; every rank gets the same answer)."
    bad = (~torch.isfinite(t)).sum().reshape(1)
    return not bool(_all_reduce(bad, mesh, None, "finite"))


def barrier(mesh: DeviceMesh, what: str) -> None:
    "Every rank of the world waits here for every other (one all-reduce of one element)."
    _all_reduce(torch.zeros(1, device=mesh.device_type), mesh, None, what)


# -- (place, step) -------------------------------------------------------------


def place_state(mesh: DeviceMesh, state):
    """This rank's block of an unsharded SVGDState: the particles and the
    amsgrad moments over p; the count replicated."""
    from phlash_tpu_torch.svgd import SVGDState

    rows = particle_sharding(mesh, state.particles.shape[0])
    return SVGDState.from_tensors(t[rows].clone() if t.ndim >= 1 else t.clone()
                                  for t in state.tensors())


def gather_state(mesh: DeviceMesh, state):
    "The whole SVGDState from each rank's block (an all-gather over p a tensor)."
    from phlash_tpu_torch.svgd import SVGDState

    return SVGDState.from_tensors(gather_rows(mesh, t, "state") if t.ndim >= 1 else t.clone()
                                  for t in state.tensors())


def shard_training_step(prog, mesh: DeviceMesh, elpd=None):
    """The port's (place, step) pair for a program of
    training.build_training(..., mesh=mesh).

    place(state): this rank's block of an unsharded SVGDState (place_state).
    step: a training.Caller of prog.base_step, the sharded SVGD step,
    `(state, inds (k, S), elpd_inds=None) -> (state, elpd)`; with `elpd`
    (mcmc.held_out_elpd of the program) the call also returns the held-out
    ELPD, the same 0-d value on every rank (phlash_tpu's aux_out).  On CUDA
    a call is a CUDA graph with its NCCL collectives inside."""
    from phlash_tpu_torch.training import Caller

    if getattr(prog, "mesh", None) is not mesh:
        raise ValueError("the program was not built for this mesh (build_training(mesh=...))")
    return (lambda state: place_state(mesh, state)), Caller(prog.base_step, elpd)
