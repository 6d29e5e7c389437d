"""Checkpoint/resume and the StepMeter of the port on the CPU: the
counterparts of tests/test_checkpoint.py, plus the writer's snapshot at
hand-off."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import logging
import os
import threading

import numpy as np

from phlash_tpu_torch import checkpoint as ckpt_mod
from phlash_tpu_torch import mcmc
from phlash_tpu_torch.checkpoint import (
    AsyncCheckpointWriter,
    TrainCheckpoint,
    load_checkpoint,
    save_checkpoint,
)
from phlash_tpu_torch.data import RawContig
from phlash_tpu_torch.profiling import StepMeter
from phlash_tpu_torch.svgd import AMSGrad, SVGDState


def _state(offset: float = 0.0) -> SVGDState:
    p = torch.arange(12.0).reshape(4, 3) + offset
    o = AMSGrad(0.1).init(p)
    return SVGDState.from_tensors((p, o.mu + 0.5, o.nu + 0.25, o.nu_max + 1.0, o.count + 7))


def _rng_states():
    gens = mcmc.generators(3, torch.device("cpu"))
    for g in gens:
        torch.rand(5, generator=g)
    return gens, tuple(g.get_state() for g in gens)


def _equal(a: SVGDState, b: SVGDState) -> bool:
    return all(torch.equal(x, y) and x.dtype == y.dtype for x, y in zip(a.tensors(), b.tensors()))


def test_checkpoint_roundtrip(tmp_path):
    "State (count included), generator states, step, ema and best step come back."
    state = _state()
    gens, rng = _rng_states()
    want = [torch.rand(3, generator=g) for g in gens]
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, TrainCheckpoint(step=42, state=state, rng_states=rng, ema=-1.5,
                                          best_step=40), {})
    back = load_checkpoint(path, state)
    assert back.step == 42 and back.best_step == 40 and back.ema == -1.5
    assert back.best_state is None and back.best_ema is None
    assert _equal(back.state, state)
    for g, s, w in zip(gens, back.rng_states, want):
        g.set_state(s)
        assert torch.equal(torch.rand(3, generator=g), w)


def test_checkpoint_best_state_sidecar_dedup(tmp_path):
    """best_state lives in a sidecar rewritten only when it changes, and a
    best == current checkpoint stores one state, not two."""
    state, best = _state(), _state(1.0)
    _, rng = _rng_states()
    path = str(tmp_path / "ckpt.npz")
    side = path + ".best.npz"
    cache = {}

    def save(step, best_step, best_state):
        save_checkpoint(path, TrainCheckpoint(step=step, state=state, rng_states=rng, ema=-1.0,
                                              best_step=best_step, best_ema=-0.5,
                                              best_state=best_state), cache)

    save(10, 6, best)
    assert os.path.exists(side)
    mtime = os.path.getmtime(side)
    back = load_checkpoint(path, state)
    assert back.best_step == 6 and back.best_ema == -0.5 and _equal(back.best_state, best)

    save(20, 6, best)  # same best iterate: the sidecar is not rewritten
    assert os.path.getmtime(side) == mtime

    save(30, 30, state)  # best == current: a flag, no best arrays anywhere
    with np.load(path) as z:
        assert not any(k.startswith("best_") for k in z.files)
    back = load_checkpoint(path, state)
    assert back.best_step == 30 and _equal(back.best_state, state)


def test_checkpoint_missing(tmp_path):
    assert load_checkpoint(str(tmp_path / "nope.npz"), _state()) is None


def test_checkpoint_shape_mismatch(tmp_path):
    path = str(tmp_path / "c.npz")
    _, rng = _rng_states()
    save_checkpoint(path, TrainCheckpoint(step=1, state=_state(), rng_states=rng, ema=None,
                                          best_step=0), {})
    bad = SVGDState.from_tensors(torch.zeros((2,) + t.shape, dtype=t.dtype)
                                 for t in _state().tensors())
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, bad)


@pytest.fixture(scope="module")
def contig():
    het = np.random.default_rng(0).integers(0, 2, size=(1, 3000)).astype(np.int8)
    return RawContig(het_matrix=het, afs=np.array([4.0, 2.0, 1.0]), window_size=100)


FIT = dict(device="cpu", kernel_backend="smc", num_particles=4, overlap=10, chunk_size=300,
           minibatch_size=2, progress=False, seed=3)


def _c(models):
    return np.stack([m.eta.c.numpy() for m in models])


def test_fit_resume(contig, tmp_path):
    "A fit interrupted and restarted continues from its checkpoint and completes."
    path = str(tmp_path / "fit.npz")
    mcmc.fit([contig], niter=4, checkpoint_path=path, save_every=2, **FIT)
    res = mcmc.fit([contig], niter=6, checkpoint_path=path, save_every=2, **FIT)
    assert len(res) == 4
    assert load_checkpoint(path, _fit_state()).step == 6


def _fit_state():
    "A template state shaped as FIT's fits build it."
    p = torch.zeros(4, 18)
    return SVGDState(particles=p, opt_state=AMSGrad(0.1).init(p))


def test_fit_resume_steps_per_call_not_dividing(contig, tmp_path, caplog):
    """Saved at iteration 4, resumed with steps_per_call 3: the run restarts
    at exactly 4 (with a warning), calls 4 + 3 + 2, and lands on niter 9."""
    path = str(tmp_path / "fit_spc.npz")
    mcmc.fit([contig], niter=4, steps_per_call=2, checkpoint_path=path, save_every=4, **FIT)
    assert load_checkpoint(path, _fit_state()).step == 4
    with caplog.at_level(logging.WARNING, logger="phlash_tpu_torch.mcmc"):
        res = mcmc.fit([contig], niter=9, steps_per_call=3, checkpoint_path=path, save_every=3,
                       **FIT)
    assert "not a multiple of steps_per_call=3" in caplog.text
    assert len(res) == 4
    assert load_checkpoint(path, _fit_state()).step == 9


@pytest.mark.parametrize("held_out", [False, True], ids=["no-elpd", "elpd"])
def test_fit_resume_matches_uninterrupted(contig, tmp_path, held_out):
    """Interrupted + resumed == uninterrupted, bit for bit.  Without held-out
    data: steps_per_call 3, saved at 3 of 6.  With it (the best-ELPD
    particles are returned, so the ELPD generator, the moving average and the
    best state must all resume): steps_per_call 5, saved at 10 of 20."""
    test = contig if held_out else None
    spc, niter, cut = (5, 20, 10) if held_out else (3, 6, 3)
    kw = dict(FIT, steps_per_call=spc, elpd_samples=2)
    want = mcmc.fit([contig], test, niter=niter, **kw)
    path = str(tmp_path / "interrupted.npz")
    mcmc.fit([contig], test, niter=cut, checkpoint_path=path, save_every=cut, **kw)
    got = mcmc.fit([contig], test, niter=niter, checkpoint_path=path, save_every=cut, **kw)
    np.testing.assert_array_equal(_c(got), _c(want))
    np.testing.assert_array_equal(np.stack([m.eta.t.numpy() for m in got]),
                                  np.stack([m.eta.t.numpy() for m in want]))
    assert [m.rho for m in got] == [m.rho for m in want]


def test_step_meter():
    m = StepMeter(sites_per_step=1e6)
    for _ in range(5):
        m.tick(10)
    assert m._steps == 50
    assert m.steps_per_sec > 0 and m.msites_per_sec > 0
    assert "50 steps" in m.summary() and "graph set-up 0.000 s" in m.summary()


def test_fit_logs_its_step_meter(contig, caplog):
    """The "fit finished" record carries the loop's StepMeter: the
    iterations it ran, and no graph set-up on the CPU."""
    with caplog.at_level(logging.INFO, logger="phlash_tpu_torch.mcmc"):
        mcmc.fit([contig], niter=3, steps_per_call=2, **FIT)
    (meter,) = [r.step_meter for r in caplog.records if hasattr(r, "step_meter")]
    assert isinstance(meter, StepMeter) and meter._steps == 3 and meter.setup_seconds == 0.0


def test_async_writer_orders_saves_and_surfaces_errors(tmp_path, monkeypatch):
    """Saves land in order and are durable after wait(); a worker exception
    re-raises on the training thread, and the writer is reusable after."""
    state = _state()
    _, rng = _rng_states()
    path = str(tmp_path / "ckpt.npz")
    w = AsyncCheckpointWriter()
    for step in (10, 20, 30):
        w.save(path, TrainCheckpoint(step=step, state=state, rng_states=rng, ema=None,
                                     best_step=step))
    w.wait()
    assert load_checkpoint(path, state).step == 30

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", boom)
    w2 = AsyncCheckpointWriter()
    w2.save(path, TrainCheckpoint(step=40, state=state, rng_states=rng, ema=None, best_step=40))
    with pytest.raises(OSError, match="disk full"):
        w2.wait()
    w2.wait()


def test_async_writer_saves_the_state_at_hand_off(tmp_path, monkeypatch):
    """The caller overwrites the state's tensors in place right after
    save() (as a graph replay does on CUDA) and before the worker writes:
    the file holds the state as it was at hand-off, best state included."""
    state, best = _state(), _state(2.0)
    want_state = SVGDState.from_tensors(t.clone() for t in state.tensors())
    want_best = SVGDState.from_tensors(t.clone() for t in best.tensors())
    gens, rng = _rng_states()
    path = str(tmp_path / "ckpt.npz")
    overwritten = threading.Event()
    real_save = ckpt_mod.save_checkpoint

    def gated_save(*a, **k):
        assert overwritten.wait(timeout=30)
        real_save(*a, **k)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", gated_save)
    w = AsyncCheckpointWriter()
    w.save(path, TrainCheckpoint(step=5, state=state, rng_states=rng, ema=-2.0, best_step=3,
                                 best_ema=-1.0, best_state=best))
    for t in (*state.tensors(), *best.tensors(), *rng):
        t.add_(1)
    overwritten.set()
    w.wait()
    back = load_checkpoint(path, state)
    assert back.step == 5 and _equal(back.state, want_state) and _equal(back.best_state, want_best)
    assert all(torch.equal(a, b - 1) for a, b in zip(back.rng_states, rng))
