"""Checkpoint/resume for the SVGD training state.

Port of phlash_tpu/checkpoint.py.  A checkpoint is one atomically replaced
.npz file holding the whole sampler state: the particles, the amsgrad
moments mu, nu, nu_max and count, the fit's generator states
(`torch.Generator.get_state()`, in place of the JAX key), the iteration, the
ELPD moving average and the best iteration and its ELPD.  `fit(...,
checkpoint_path=..., save_every=...)` wires it in; a run restarted with the
same arguments resumes at the saved iteration.

The best-held-out-ELPD state is stored out of the periodic file, in a
sidecar ``<path>.best.npz`` rewritten only when the best iterate changes;
when the best iterate is the current one, the main file records just that.

`AsyncCheckpointWriter` writes on a worker thread.  JAX arrays are
immutable, so phlash_tpu's worker sees the state as it was at hand-off; the
port's state on CUDA is a set of static buffers that the next graph replay
overwrites in place.  So `save` snapshots every tensor when it is called:
a copy into pinned host memory on the tensor's stream, with an event that
the worker waits on before it writes (a clone on the CPU).

The writer's work is part of the fit's record (profiling.py): its counters
`ckpt_saves` (saves handed off), `ckpt_bytes` (the bytes their snapshots
copied) and `ckpt_waits` (saves that had to join a write still running)
belong to every fit's record and go to the fit's innermost recorded open
span; each write is a span `phlash.checkpoint.write`, stamped on the worker
thread around the wait for the snapshot and the file's write, and recorded
in the fit when the training thread joins the worker.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from phlash_tpu_torch import profiling
from phlash_tpu_torch.svgd import SVGDState

logger = logging.getLogger(__name__)

STATE_NAMES = ("particles", "mu", "nu", "nu_max", "count")  # SVGDState.tensors() order
WRITE_SPAN = "phlash.checkpoint.write"  # a write on the worker thread (profiling.add)
SAVE_COUNTS = ("ckpt_saves", "ckpt_bytes", "ckpt_waits")


class _Saves(profiling.Tally):
    """The writers' counters (SAVE_COUNTS), in every fit's record; what they
    add also goes to the fit's innermost recorded open span (profiling.count),
    so that a call's span holds the saves made in it."""

    __slots__ = ()

    def add(self, key: str, n: int = 1) -> None:
        super().add(key, n)
        profiling.count(key, n)


tally = _Saves(SAVE_COUNTS, fit_record=True)

# best_state storage modes in the meta record
_BEST_NONE = 0  # no best state tracked
_BEST_SIDECAR = 1  # best state lives in <path>.best.npz
_BEST_IS_CURRENT = 2  # best state == the main file's state


@dataclass
class TrainCheckpoint:
    step: int
    state: SVGDState
    rng_states: tuple  # torch.Generator.get_state() of each of the fit's generators
    ema: float | None
    best_step: int
    best_ema: float | None = None
    best_state: SVGDState | None = None  # best-held-out-ELPD state, if tracked


def _best_path(path: str) -> str:
    return path + ".best.npz"


def _write_npz_atomic(path: str, arrays: dict) -> None:
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def _arrays(state: SVGDState, prefix: str = "") -> dict:
    return {prefix + name: t.detach().cpu().numpy()
            for name, t in zip(STATE_NAMES, state.tensors())}


def save_checkpoint(path: str, ckpt: TrainCheckpoint, cache: dict) -> None:
    """Persist a TrainCheckpoint atomically to `path` (.npz).

    `cache` is a caller-held dict that lets repeated saves from the same
    run skip rewriting the best-state sidecar while the best iterate is
    unchanged.
    """
    arrays = _arrays(ckpt.state)
    for i, s in enumerate(ckpt.rng_states):
        arrays[f"rng_{i}"] = s.numpy()

    if ckpt.best_state is None:
        best_mode = _BEST_NONE
    elif ckpt.best_state is ckpt.state or ckpt.best_step == ckpt.step:
        best_mode = _BEST_IS_CURRENT
    else:
        best_mode = _BEST_SIDECAR
        # the sidecar changes only when a new best iterate appears; write it
        # before the main file so a crash in between leaves a readable
        # (older) main file rather than a main file pointing at nothing
        if cache.get("best_step_written") != ckpt.best_step:
            best_arrays = _arrays(ckpt.best_state, "best_")
            best_arrays["__best_step"] = np.array(ckpt.best_step, dtype=np.int64)
            _write_npz_atomic(_best_path(path), best_arrays)
            cache["best_step_written"] = ckpt.best_step

    arrays["__meta"] = np.array(
        [ckpt.step, ckpt.best_step, ckpt.ema is not None, best_mode, ckpt.best_ema is not None],
        dtype=np.int64,
    )
    arrays["__ema"] = np.array(ckpt.ema if ckpt.ema is not None else 0.0)
    arrays["__best_ema"] = np.array(ckpt.best_ema if ckpt.best_ema is not None else 0.0)
    _write_npz_atomic(path, arrays)
    logger.debug("checkpoint saved at step %d -> %s", ckpt.step, path)


def _snapshot(ckpt: TrainCheckpoint) -> tuple[TrainCheckpoint, torch.cuda.Event | None, int]:
    """A copy of `ckpt` whose tensors nothing later changes, the event
    after which its host copies of CUDA tensors are complete (None if it
    has none), and the bytes copied."""
    cuda = None  # the device of the CUDA tensors copied, if any
    nbytes = 0

    def copy(state: SVGDState) -> SVGDState:
        nonlocal cuda, nbytes
        out = []
        for t in state.tensors():
            nbytes += t.numel() * t.element_size()
            if t.is_cuda:
                cuda = t.device
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
            else:
                h = t.detach().clone()
            out.append(h)
        return SVGDState.from_tensors(out)

    state = copy(ckpt.state)
    best = ckpt.best_state
    if best is not None:
        best = state if best is ckpt.state else copy(best)
    event = None
    if cuda is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(cuda))
    rng_states = tuple(s.clone() for s in ckpt.rng_states)
    nbytes += sum(s.numel() * s.element_size() for s in rng_states)
    return replace(ckpt, state=state, best_state=best, rng_states=rng_states), event, nbytes


class AsyncCheckpointWriter:
    """Single-flight background saver: the training loop hands off a
    TrainCheckpoint and keeps stepping while the npz write happens on a
    worker thread.

    `save` snapshots the checkpoint's tensors before it returns (see the
    module docstring), so the file holds the state as it was at hand-off.
    Saves are strictly ordered (a new save joins the previous one first —
    they are `save_every` iterations apart, so an actual wait means disk is
    slower than training and throttling is the right behavior).  A worker
    exception is re-raised on the next save()/wait(), so failures surface on
    the training thread.  Each save and its write are counted and spanned
    (see the module docstring); the write's span is recorded at the join.
    """

    def __init__(self):
        self._thread = None
        self._cache: dict = {}
        self._err: BaseException | None = None
        self._written: tuple | None = None  # the worker's (start, end, step) of its write

    def _join(self, raise_error: bool = True) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            start, end, step = self._written
            profiling.add(WRITE_SPAN, start, end, step=step)
        if self._err is not None:
            err, self._err = self._err, None
            if raise_error:
                raise err
            logger.error("checkpoint write failed: %r", err, exc_info=err)

    def save(self, path: str, ckpt: TrainCheckpoint) -> None:
        if self._thread is not None and self._thread.is_alive():
            tally.add("ckpt_waits")
        self._join()
        snap, ready, nbytes = _snapshot(ckpt)
        tally.add("ckpt_saves")
        tally.add("ckpt_bytes", nbytes)

        def work():
            start = time.perf_counter_ns()
            try:
                if ready is not None:
                    ready.synchronize()
                save_checkpoint(path, snap, self._cache)
            except BaseException as e:  # surfaced on the training thread
                self._err = e
            finally:
                self._written = (start, time.perf_counter_ns(), snap.step)

        self._thread = threading.Thread(target=work, name="ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self, raise_error: bool = True) -> None:
        """Block until the in-flight save (if any) is durable.  With
        raise_error=False a worker's exception is logged, not raised: the
        caller is already handling one that it must not mask."""
        self._join(raise_error)


def load_checkpoint(path: str, example_state: SVGDState) -> TrainCheckpoint | None:
    """Restore a TrainCheckpoint whose tensors match example_state's shapes,
    on its device, or None when there is no file."""
    if not os.path.exists(path):
        return None
    want = example_state.tensors()
    dev = want[0].device

    def load(z, prefix: str = "") -> SVGDState:
        return SVGDState.from_tensors(torch.as_tensor(z[prefix + name]).to(dev)
                                      for name in STATE_NAMES)

    with np.load(path) as z:
        for name, w in zip(STATE_NAMES, want):
            if z[name].shape != tuple(w.shape):
                raise ValueError(
                    f"checkpoint shape mismatch: {z[name].shape} vs {tuple(w.shape)}; "
                    "was the run configured differently?"
                )
        state = load(z)
        n_rng = sum(k.startswith("rng_") for k in z.files)
        rng_states = tuple(torch.as_tensor(z[f"rng_{i}"]) for i in range(n_rng))
        step, best_step, has_ema, best_mode, has_best_ema = (int(v) for v in z["__meta"])
        ema = float(z["__ema"]) if has_ema else None
        best_ema = float(z["__best_ema"]) if has_best_ema else None

    best_state = None
    if best_mode == _BEST_IS_CURRENT:
        best_state = state
    elif best_mode == _BEST_SIDECAR:
        bp = _best_path(path)
        if os.path.exists(bp):
            with np.load(bp) as zb:
                if int(zb["__best_step"]) == best_step:
                    best_state = load(zb, "best_")
                else:  # crash between sidecar and main writes: stale sidecar
                    logger.warning(
                        "best-state sidecar %s is from step %d but the checkpoint records "
                        "best_step=%d; dropping the best-state tracker (training state is "
                        "unaffected)", bp, int(zb["__best_step"]), best_step,
                    )
        else:
            logger.warning("best-state sidecar %s missing; dropping the tracker", bp)

    logger.info("resumed from checkpoint %s at step %d", path, step)
    return TrainCheckpoint(step=step, state=state, rng_states=rng_states, ema=ema,
                           best_step=best_step, best_ema=best_ema, best_state=best_state)
