"""SVGD posterior sampling: `fit(data, test_data, **options)`.

Port of phlash_tpu/mcmc.py:66-413 for one device: the chunk cap, the loop of
calls of `steps_per_call` SVGD iterations (CUDA graph replays on CUDA, see
training.Caller; the final call may be partial), the periodic finiteness
check, the held-out ELPD fused into the call (an exponential moving average
over evaluations every 10 iterations, with `elpd_cutoff` iterations of
patience), checkpoint/resume with the asynchronous writer, the fit's record
of spans (profiling.FitTrace), and the return of the best-ELPD particles
(or the last ones with `return_final=True`).  With steps_per_call > 1 the
periodic cadences (finiteness, ELPD, checkpoint) land on the first call at
or after their scheduled iteration, and the best state pairs the call's
first iteration with the particles after the call, as in phlash_tpu.

Options with the JAX defaults: niter, num_particles, window_size, overlap,
chunk_size, minibatch_size, learning_rate, sigma, theta, mutation_rate,
truth (a DemographicModel: mutation_rate = truth.theta; giving both raises
ValueError), init (an MCMCParams: the initial cloud's centre),
afs_transform, pattern, t1, tM, rho_over_theta, alpha, beta, elpd_cutoff,
elpd_samples, max_samples (held-out rows, 20), num_workers (processes that
read and chunk contigs from files, see data.init_mcmc_data; None: one per
CPU), return_final,
double_precision_params (a float64 cloud and assembly), double_precision
and kernel_seg_len (see kernel.py: float64 kernel state on "dense" and
"scan" only; a segment length on "dense" only), steps_per_call (10 on CUDA,
1 on the CPU), check_every (10; 1 when the environment sets PHLASH_TPU_DEBUG,
as in phlash_tpu), checkpoint_path, save_every (50), progress
(True; a tqdm bar when tqdm imports) and callback: called after each call
with the cloud as one batched DemographicModel in per-window-base units
(rescaled by the mutation rate when known), read back to the host once a
call.  Without a callback, fit uses liveplot.liveplot_cb (a live plot in a
Jupyter notebook with plotly) and, where that raises, none: then nothing is
read back between calls.  `data` and `test_data` are data.Contig objects
(contig(), RawContig, VcfContig, TreeSequenceContig).  New in the port:
device (default "cuda"; no card means an error, never a CPU fallback),
seed and kernel_backend, the likelihood algorithm:
"smc" (the default; phlash_tpu's "pallas"), "packed" (phlash_tpu's
"pallas_mxu"; needs overlap=0), "dense" or "scan"; see kernel.py.  The
device decides between the hand CUDA kernels and their plain versions.

`seed` seeds two torch.Generators on the device: the step's (the initial
cloud and every call's minibatch indices) with `seed` itself, and the
held-out ELPD's with a seed derived from `seed` and ELPD_STREAM.  So the
ELPD leaves the step stream alone, as phlash_tpu's fold_in does.
phlash_tpu's key raises NotImplementedError when set (use seed).

Where the held-out chunks outnumber elpd_samples, every evaluation of a
fit visits one subset of them, drawn from the ELPD's generator before the
first call; the generator draws nothing after that, so a checkpoint stores
the step generator's state alone and a resumed fit visits the subset of
the uninterrupted one.  phlash_tpu draws a fresh subset at each evaluation
(phlash_tpu/mcmc.py:180-187, 246-250), and the sum over another subset can
differ by ten times what the whole fit gains: the moving average, its best
iteration and the early stop then follow the draws, and the fit returns
the cloud of an early call, in phlash_tpu as in the port with its draws
(ROADMAP.md §C).

mesh (parallel.make_mesh()): the multi-GPU fit, one process per device
(`torchrun --nproc-per-node N script.py`; phlash_tpu runs one program over
its devices instead).  Every rank reads the data and draws the same cloud
and indices from the same generators; it keeps its block of particles
(mesh axis "p", which must divide num_particles: a cloud is not padded)
and of chunks and held-out chunks ("d"), and the sharded step and ELPD
exchange what parallel/mesh.py lists.  The ELPD is the mean over every
particle, and the finiteness check reads every rank, so every rank takes
the same branch.  The checkpoint holds the whole cloud and both
generators, written by rank 0; a resume on any mesh whose p divides the
cloud continues it as if uninterrupted.  The callback and the progress bar
run on rank 0 with the whole cloud, and every rank returns the same list
of models.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from phlash_tpu_torch import profiling
from phlash_tpu_torch.checkpoint import AsyncCheckpointWriter, TrainCheckpoint, load_checkpoint
from phlash_tpu_torch.data import Contig, chunk_het_matrix, init_mcmc_data
from phlash_tpu_torch.kernel import check_backend, get_kernel, resolve_device
from phlash_tpu_torch.kernel_base import upload
from phlash_tpu_torch.model import log_density_batched, log_density_rows
from phlash_tpu_torch.parallel import mesh as comms
from phlash_tpu_torch.params import MCMCParams
from phlash_tpu_torch.size_history import DemographicModel, SizeHistory
from phlash_tpu_torch.training import (
    Caller,
    TrainingProgram,
    build_training,
    clone_state,
    resolve_minibatch_size,
)

logger = logging.getLogger(__name__)

_OPTIONS = {
    "niter", "num_particles", "window_size", "overlap", "chunk_size", "minibatch_size",
    "learning_rate", "sigma", "theta", "mutation_rate", "truth", "init", "afs_transform",
    "pattern", "t1", "tM", "rho_over_theta", "alpha", "beta", "elpd_cutoff", "elpd_samples",
    "max_samples", "num_workers", "return_final", "double_precision_params", "double_precision",
    "kernel_seg_len", "steps_per_call", "check_every", "checkpoint_path", "save_every",
    "progress", "callback", "mesh",
}
# phlash_tpu.fit options without a counterpart here (None is accepted)
_NOT_IMPLEMENTED = ("key",)
CHECK_EVERY = 10  # iterations between finiteness checks (each one syncs the device)
DEBUG_ENV = "PHLASH_TPU_DEBUG"  # set (to anything but ""): a check after every call
ELPD_EVERY = 10  # iterations between held-out ELPD evaluations
SAVE_EVERY = 50  # iterations between checkpoint saves
ELPD_STREAM = 0x0E1D  # derives the ELPD generator's seed (phlash_tpu's fold_in constant)


def default_check_every() -> int:
    """Iterations between finiteness checks when fit is given no check_every:
    1 when DEBUG_ENV is set, else CHECK_EVERY (phlash_tpu/mcmc.py:316-323;
    the reference's PHLASH_DEBUG_MODE)."""
    return 1 if os.environ.get(DEBUG_ENV) else CHECK_EVERY


def _check_finite(particles: torch.Tensor, mesh, i: int) -> None:
    "Raise if a particle is not finite (a sync with the device; on a mesh, every rank's)."
    with profiling.call_span("phlash.call.finite_check"):
        profiling.count("host_syncs")
        if mesh is None:
            finite = bool(torch.isfinite(particles).all())
        else:
            finite = comms.all_finite(mesh, particles)
    if not finite:
        raise RuntimeError(f"non-finite particles at iteration {i}")


def _check_options(options: dict) -> None:
    for k, v in options.items():
        if k in _OPTIONS:
            continue
        if k in _NOT_IMPLEMENTED:
            if v is None:
                continue
            raise NotImplementedError(f"fit option {k}={v!r} is not implemented (use seed=)")
        raise TypeError(f"fit got an unknown option {k!r}")


def generators(seed: int, device: torch.device) -> tuple[torch.Generator, torch.Generator]:
    "(step generator, ELPD generator) of a fit: see the module docstring."
    elpd_seed = int(np.random.SeedSequence([seed, ELPD_STREAM]).generate_state(1)[0])
    return (torch.Generator(device=device).manual_seed(seed),
            torch.Generator(device=device).manual_seed(elpd_seed))


def cloud(prog: TrainingProgram, particles: torch.Tensor) -> DemographicModel:
    """The particles, read back to the host once, as one batched demographic
    model in per-window-base units (and generations when the mutation rate
    is known): phlash_tpu's dms()."""
    with torch.no_grad():
        dm = prog.init.unflatten(particles.detach().cpu()).to_dm()
    dm = DemographicModel(eta=dm.eta, theta=dm.theta / prog.window_size,
                          rho=dm.rho / prog.window_size)
    return dm.rescale(prog.mutation_rate) if prog.mutation_rate else dm


def _models(prog: TrainingProgram, particles: torch.Tensor) -> list[DemographicModel]:
    "Particles as a list of demographic models, as `cloud` has them."
    dm = cloud(prog, particles)
    return [DemographicModel(eta=SizeHistory(t=dm.eta.t[k], c=dm.eta.c[k]), theta=dm.theta,
                             rho=float(dm.rho[k]))
            for k in range(dm.eta.t.shape[0])]


@dataclass
class HeldOutELPD:
    """The held-out ELPD (phlash_tpu/mcmc.py:136-198): the held-out rows are
    chunked like the training data, and an evaluation visits `S` of the `N`
    chunks, drawn by `draw` (all of them when S == N; fit draws them once).
    `self(particles, inds)` is the mean held-out log density over the
    particles, a 0-d tensor, through the forward kernel alone; it runs
    inside a captured call, so it reads nothing back to the host.  With
    `chunks` (a mesh's block of the held-out chunks) it takes this rank's
    block of particles and returns the mean over every particle, the same
    on every rank (parallel/mesh.reduce_elpd)."""

    init: MCMCParams
    kern: object
    warmup: torch.Tensor  # (N, overlap) int8; with a mesh, this rank's rows
    afs: torch.Tensor | None
    afs_transform: torch.Tensor | None
    N: int
    S: int
    chunks: comms.ShardedChunks | None = None

    def draw(self, generator: torch.Generator) -> torch.Tensor:
        "The (S,) chunk indices of one evaluation, without replacement."
        dev = self.warmup.device
        if self.S == self.N:
            return torch.arange(self.N, device=dev)
        return torch.randperm(self.N, generator=generator, device=dev)[: self.S]

    def __call__(self, particles: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
        if self.chunks is not None:
            return self._sharded(particles, inds)
        with torch.no_grad():  # forward kernel only, no residuals
            return log_density_batched(
                self.init.unflatten(particles), c=(0.0, 1.0, 1.0), inds=inds,
                warmup=self.warmup[inds], kern=self.kern, afs=self.afs,
                afs_transform=self.afs_transform,
            ).mean()

    def _sharded(self, particles: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
        mesh = self.chunks.mesh
        with torch.no_grad():
            warm, rows = self.chunks.fetch(inds)
            mine = comms.share(mesh, len(inds))
            total = log_density_rows(
                self.init.unflatten(particles), (0.0, 1.0, 1.0), warm[mine], rows[mine],
                self.kern, self.afs, self.afs_transform,
                prior_and_afs=mesh.get_local_rank(comms.CHUNK_AXIS) == 0)
            return comms.reduce_elpd(mesh, total)


@profiling.spanned("phlash.start.elpd_setup")
def held_out_elpd(prog: TrainingProgram, test_data: Contig, *, span: int, overlap: int,
                  elpd_samples: int | None, device, kernel_backend: str, max_samples: int = 20,
                  double_precision: bool = False, seg_len=None) -> HeldOutELPD:
    """The held-out ELPD of the first `max_samples` rows of `test_data` for
    `prog`, whose chunks span `span` columns; elpd_samples chunks an
    evaluation (default max(S, 4)); the kernel as the training one."""
    d = test_data.get_data(prog.window_size)
    test_afs = None
    if d["afs"] is not None:
        test_afs = torch.as_tensor(np.asarray(d["afs"]), dtype=torch.float32, device=device)
    test_chunks = chunk_het_matrix(d["het_matrix"][:max_samples], overlap=overlap,
                                   chunk_size=span - overlap)
    N = len(test_chunks)
    T = None
    if test_afs is not None and prog.afs_transform is not None:
        if prog.afs_transform.shape[1] == len(test_afs):
            T = prog.afs_transform

    def make_kernel(body: np.ndarray):
        return get_kernel(M=prog.init.M, data=np.ascontiguousarray(body), device=device,
                          backend=kernel_backend, double_precision=double_precision,
                          seg_len=seg_len)

    S = min(N, int(elpd_samples or max(prog.S, 4)))
    if prog.mesh is not None:  # this rank's block of the held-out chunks
        sharded = comms.shard_chunks(prog.mesh, test_chunks[:, :overlap],
                                     test_chunks[:, overlap:], make_kernel, what="elpd_rows")
        return HeldOutELPD(init=prog.init, kern=sharded.kern, warmup=sharded.warmup,
                           afs=test_afs, afs_transform=T, N=N, S=S, chunks=sharded)
    return HeldOutELPD(
        init=prog.init, kern=make_kernel(test_chunks[:, overlap:]),
        warmup=upload(np.ascontiguousarray(test_chunks[:, :overlap]), device),
        afs=test_afs, afs_transform=T, N=N, S=S,
    )


def _progress(calls, enabled: bool):
    "A tqdm bar over the calls when tqdm imports, else the calls."
    try:
        import tqdm.auto as tqdm
    except ImportError:
        return calls
    return tqdm.tqdm(calls, disable=not enabled, desc="fitting model")


@profiling.records_fit
def fit(data: list[Contig], test_data: Contig = None, *, device="cuda", seed: int = 1,
        kernel_backend: str = None, **options) -> list[DemographicModel]:
    """Sample demographic models from the posterior.

    Returns one DemographicModel per particle, rescaled to per-base-pair
    rates (and to generations when mutation_rate is given).  With
    `test_data`, the particles of the call with the best held-out ELPD are
    returned unless `return_final=True`.  With `checkpoint_path`, the state
    is saved every `save_every` iterations and at the end, and a run
    restarted with the same arguments resumes at the saved iteration; fit
    returns or raises only after the last save it handed off is written,
    also when the callback raises.

    Each fit records its spans in a profiling.FitTrace, which
    `profiling.last_fit()` returns and the "fit finished" log record carries
    as `fit_trace` (its `iterations`, its `rate` between the first callback
    and the last, and its `setup_seconds`: the CUDA graphs' warm-up and
    capture).  The start's spans (phlash.start, phlash.start.ingest,
    phlash.ingest.*, phlash.start.build, phlash.start.upload,
    phlash.start.elpd_setup, phlash.capture) are always recorded; each
    call's (phlash.call and phlash.call.draw, .launch, .finite_check,
    .elpd_read, .checkpoint, .readback, .user_callback, with the counter
    host_syncs; on a mesh phlash.mesh.collective) only while torch's
    profiler records, e.g. inside
    `profiling.trace()`, whose Chrome trace then shows them beside the
    device's work.  See profiling.py.
    """
    rec = profiling.last_fit()
    with profiling.span("phlash.start"):
        _check_options(options)
        kernel_backend = check_backend(kernel_backend, options.get("overlap", 500),
                                       options.get("double_precision", False),
                                       options.get("kernel_seg_len"))
        dev = resolve_device(device)
        mesh = options.get("mesh")
        if mesh is not None:
            if not isinstance(mesh, DeviceMesh):
                raise TypeError("mesh must be a DeviceMesh of parallel.make_mesh, got "
                                f"{type(mesh)}")
            if mesh.device_type != dev.type:
                raise ValueError(f"a {mesh.device_type} mesh cannot fit on device {device!r}")
            comms.particle_sharding(mesh, options.get("num_particles", 500))  # p must divide it
        rank0 = mesh is None or dist.get_rank() == 0

        def whole(t: torch.Tensor) -> torch.Tensor:
            "The whole cloud's rows of this rank's block `t`, on every rank."
            return t if mesh is None else comms.gather_rows(mesh, t, "particles")

        def whole_state(s):
            return s if mesh is None else comms.gather_state(mesh, s)

        gen, elpd_gen = generators(seed, dev)
        niter = options.get("niter", 1000)
        window_size = options.get("window_size", 100)
        overlap = options.get("overlap", 500)

        afs, chunks = init_mcmc_data(data, window_size, overlap, options.get("chunk_size"),
                                     options.get("max_samples", 20), options.get("num_workers"))
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
                              kernel_backend=kernel_backend, mesh=mesh)
        state = prog.state
        call, elpd = prog.step, None
        if test_data is not None:
            elpd = held_out_elpd(prog, test_data, span=int(chunks.shape[-1]), overlap=overlap,
                                 elpd_samples=options.get("elpd_samples"), device=dev,
                                 kernel_backend=kernel_backend,
                                 max_samples=options.get("max_samples", 20),
                                 double_precision=options.get("double_precision", False),
                                 seg_len=options.get("kernel_seg_len"))
            call = Caller(prog.base_step, elpd)
            elpd_inds = elpd.draw(elpd_gen)  # one subset for every evaluation of the fit

        spc = prog.steps_per_call
        callback = options.get("callback")
        if callback is None:
            try:
                from phlash_tpu_torch.liveplot import liveplot_cb

                callback = liveplot_cb(truth=options.get("truth"))
            except Exception as e:  # no live-plot backend: read nothing back between calls
                logger.debug("no live plot: %s", e)
                callback = None
        elpd_cutoff = options.get("elpd_cutoff", 100)
        check_every = options.get("check_every", default_check_every())
        ckpt_path = options.get("checkpoint_path")
        save_every = options.get("save_every", SAVE_EVERY)
        start, ema, best = 0, None, None  # best = (iteration, ema, state snapshot)
        writer = None
        if ckpt_path:
            writer = AsyncCheckpointWriter() if rank0 else None
            resumed = load_checkpoint(ckpt_path, whole_state(state))
            if resumed is not None:
                place = (lambda s: s) if mesh is None else (lambda s: comms.place_state(mesh, s))
                state, start, ema = place(resumed.state), resumed.step, resumed.ema
                gen.set_state(resumed.rng_states[0])
                if resumed.best_state is not None:
                    best = (resumed.best_step, resumed.best_ema, place(resumed.best_state))
                if start % spc:
                    logger.warning("resuming from iteration %d, which is not a multiple of "
                                   "steps_per_call=%d; call boundaries realign from there",
                                   start, spc)

        def save(step: int) -> None:
            "The checkpoint of `step`, whole (a collective under a mesh), to rank 0's writer."
            ckpt = TrainCheckpoint(
                step=step, state=whole_state(state),
                rng_states=(gen.get_state(),), ema=ema,
                best_step=best[0] if best else step, best_ema=best[1] if best else None,
                best_state=whole_state(best[2]) if best else None,
            )
            if writer is not None:
                writer.save(ckpt_path, ckpt)  # snapshots at hand-off

        pbar = _progress(range(start, niter, spc), options.get("progress", True) and rank0)
        patience = 0
        next_check = next_elpd = start
        next_save = start + save_every
        last, saved_at = start, None
    try:
        for i in pbar:
            k = min(spc, niter - i)  # the final call may be partial
            with profiling.loop_call(k):
                with profiling.call_span("phlash.call.draw"):
                    inds = torch.randint(prog.N, (k, prog.S), generator=gen, device=dev)
                want_elpd = elpd is not None and i >= next_elpd
                state, e_dev = call(state, inds, elpd_inds if want_elpd else None)
                if i >= next_check or i + k >= niter:
                    next_check = i + check_every
                    _check_finite(state.particles, mesh, i)
                rec.iterations += k
                last = i + k
                stop = False
                if want_elpd:
                    next_elpd = i + ELPD_EVERY
                    with profiling.call_span("phlash.call.elpd_read"):
                        e = float(e_dev)
                        profiling.count("host_syncs")
                    ema = e if ema is None else 0.9 * ema + 0.1 * e
                    if best is None or ema > best[1]:
                        patience = 0
                        best = (i, ema, clone_state(state))
                    else:
                        patience += 1
                    stop = i - best[0] > elpd_cutoff
                    if hasattr(pbar, "set_description"):
                        pbar.set_description(f"elpd={ema:.2f} patience={patience}")
                # saved after the call's ELPD, so that the saved ema and best state
                # go with the saved state (a resume then evaluates at its first call)
                if ckpt_path and last >= next_save:
                    next_save = last + save_every
                    saved_at = last
                    with profiling.call_span("phlash.call.checkpoint"):
                        save(last)
                if stop:
                    logger.info("ELPD has not improved in %d iterations; stopping early",
                                elpd_cutoff)
                    break
                rec.at_callback()
                if callback is not None:
                    with profiling.call_span("phlash.call.readback"):
                        particles = whole(state.particles)
                        if rank0:
                            dm = cloud(prog, particles)
                            profiling.count("host_syncs")
                    if rank0:
                        with profiling.call_span("phlash.call.user_callback"):
                            callback(dm)
    except BaseException:
        if writer is not None:
            # leave no write in flight: the caller may next delete the file's
            # directory or resume from it.  A failed write is logged, so that
            # it does not mask the exception on its way out; no mesh barrier,
            # since a raising rank must not wait on the others
            writer.wait(raise_error=False)
        raise
    if ckpt_path:
        if last != saved_at and last > start:
            # leave the run's final state on disk, so that a rerun with the
            # same arguments resumes at niter and takes no step
            save(last)
        if writer is not None:
            writer.wait()
        if mesh is not None:
            # every rank waits for rank 0's last write, so that none reads
            # the checkpoint (in a next fit) before it is on disk; the
            # all-gather over p below joins only rank 0's p group
            comms.barrier(mesh, "saved")
    logger.info("fit finished: %s", rec.summary(), extra={"fit_trace": rec})
    particles = state.particles
    if best is not None and not options.get("return_final", False):
        logger.info("returning best-ELPD state from iteration %d", best[0])
        particles = best[2].particles
    return _models(prog, whole(particles))
