"""profiling.trace and the fit's spans and counters on the CPU.

The counterpart of phlash_tpu/profiling.py: `trace` profiles a block with
torch.profiler and writes a Chrome trace under its log directory when the
block exits (phlash_tpu: jax.profiler); on the card the same file names
the CUDA kernels (chip_smoke.py phase 8c).  New in the port: each fit's
FitTrace (its StepMeter's iterations and rate, and the spans and counters
that benchmark/metrics/ reads).
"""

import contextlib
import glob
import importlib.util
import json
import os
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from phlash_tpu_torch import mcmc, profiling, training  # noqa: E402
from phlash_tpu_torch.data import RawContig, chunk_het_matrix, init_mcmc_data  # noqa: E402
from phlash_tpu_torch.profiling import trace  # noqa: E402
from phlash_tpu_torch.svgd import AMSGrad, SVGDState  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _names(path: str) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    "One trace file under log_dir, written when the block exits, naming the ops it ran."
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as d:
        assert d == log_dir
        x = torch.randn(64, 64)
        (x @ x).sum()
        assert not glob.glob(os.path.join(log_dir, "*.json"))
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert "aten::mm" in _names(path)


def test_trace_default_directory(tmp_path, monkeypatch):
    "The default log directory is the port's own, in the temporary directory."
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with trace() as d:
        torch.ones(3).sum()
    assert d == os.path.join(str(tmp_path), "phlash_tpu_torch_trace")
    assert len(glob.glob(os.path.join(d, "*.pt.trace.json"))) == 1


def test_trace_writes_even_when_the_block_raises(tmp_path):
    "The block's error propagates and its trace is still written."
    with pytest.raises(RuntimeError, match="boom"):
        with trace(str(tmp_path)):
            torch.ones(3).sum()
            raise RuntimeError("boom")
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 1


def test_step_meter_counts_iterations(monkeypatch):
    """A FitTrace counts the iterations of each call, and their rate between
    the first callback and the last (host clock)."""
    rec = profiling.FitTrace()
    clock = iter([100_000_000_000, 102_000_000_000])
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(clock))
    rec.iterations += 10
    rec.at_callback()
    rec.iterations += 13
    rec.at_callback()
    assert rec.iterations == 23
    assert rec.rate == 6.5
    assert rec.summary().startswith("23 steps, 6.50 it/s, graph set-up 0.000 s")


def _contig(seed: int) -> RawContig:
    het = np.random.default_rng(seed).integers(0, 2, size=(1, 600)).astype(np.int8)
    return RawContig(het_matrix=het, afs=np.array([4.0, 2.0, 1.0]), window_size=100)


TRAIN, HELD_OUT = _contig(0), _contig(1)
# calls of ten with the finiteness check and the held-out ELPD on each
FIT = dict(device="cpu", kernel_backend="smc", num_particles=4, overlap=4, chunk_size=20,
           minibatch_size=1, progress=False, seed=3, niter=20, steps_per_call=10,
           check_every=10)
CALL_CHILDREN = {"phlash.call.draw", "phlash.call.launch", "phlash.call.finite_check",
                 "phlash.call.elpd_read", "phlash.call.readback", "phlash.call.user_callback"}
READERS = ("launch_ms_per_call", "readback_ms_per_call", "syncs_per_call", "fit_ingest_s",
           "upload_s", "capture_s", "hmm_fix_share", "hmm_trim_share")


def _read(name: str):
    "benchmark/metrics/<name>.py's reading of the newest fit, loaded as the harness loads it."
    spec = importlib.util.spec_from_file_location(f"reader_{name}",
                                                  ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(SimpleNamespace(trace=None, shapes=None, spans={}))


@pytest.fixture(scope="module")
def untraced():
    "(models, FitTrace) of a fit with a callback and the profiler off."
    models = mcmc.fit([TRAIN], HELD_OUT, callback=lambda dm: None, **FIT)
    return models, profiling.last_fit()


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(models, FitTrace, the Chrome trace's path, the readers' readings)
    of the same fit inside profiling.trace."""
    log_dir = str(tmp_path_factory.mktemp("fit_trace"))
    with trace(log_dir):
        models = mcmc.fit([TRAIN], HELD_OUT, callback=lambda dm: None, **FIT)
    rec = profiling.last_fit()
    readings = {name: _read(name) for name in READERS}
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    return models, rec, path, readings


def test_tracing_leaves_the_fit_bitwise_equal(untraced, traced):
    "The spans change no number: the same particles, bit for bit, with the profiler on."
    for a, b in zip(untraced[0], traced[0]):
        assert torch.equal(a.eta.t, b.eta.t) and torch.equal(a.eta.c, b.eta.c)
        assert a.rho == b.rho


def test_without_the_profiler_only_the_start_is_recorded(untraced):
    "The start's spans, each under its parent; no call span; a call's site opens a shared no-op."
    rec = untraced[1]
    names = [s.name for s in rec.spans]
    assert names == ["phlash.fit", "phlash.start", "phlash.start.ingest", "phlash.ingest.read",
                     "phlash.ingest.concat", "phlash.start.build", "phlash.start.upload",
                     "phlash.start.upload", "phlash.start.elpd_setup", "phlash.start.upload",
                     "phlash.start.upload"]
    parents = [None if s.parent is None else names[s.parent] for s in rec.spans]
    assert parents == [None, "phlash.fit", "phlash.start", "phlash.start.ingest",
                       "phlash.start.ingest", "phlash.start", "phlash.start.build",
                       "phlash.start.build", "phlash.start", "phlash.start.elpd_setup",
                       "phlash.start.elpd_setup"]
    assert rec.closed and all(s.end >= s.start and s.fit == rec.id for s in rec.spans)
    assert rec.iterations == FIT["niter"] and rec.calls() == []
    assert rec.per_call("phlash.call.launch") is None

    def sites():
        return profiling.call_span("phlash.call.draw"), profiling.call_span("phlash.call.launch")

    a, b = profiling.records_fit(sites)()
    assert a is b and not profiling.last_fit().spans[1:]


def test_each_call_is_whole_under_the_profiler(traced):
    """Every call span holds its draw, launch, finiteness check, ELPD read,
    read-back and callback, all of one fit and one call, covering >= 90% of it."""
    rec = traced[1]
    calls = rec.calls()
    assert [c.attrs for c in calls] == [{"call": 0, "k": 10}, {"call": 1, "k": 10}]
    for c in calls:
        kids = [s for s in rec.spans if s.parent == rec.spans.index(c)]
        assert {s.name for s in kids} == CALL_CHILDREN and len(kids) == len(CALL_CHILDREN)
        assert all(s.fit == rec.id and s.call == c.call and not s.raised for s in kids)
        assert sum(s.seconds for s in kids) >= 0.9 * c.seconds


def test_host_syncs_per_call(traced, monkeypatch):
    """host_syncs: 3 a call (finiteness, ELPD, read-back) with a callback;
    2 without one, where nothing is read back."""
    rec = traced[1]
    assert [c.counts["host_syncs"] for c in rec.calls()] == [3, 3]
    assert rec.count_per_call("host_syncs") == 3.0

    def no_live_plot(**kw):
        raise ImportError("no live plot")

    monkeypatch.setattr("phlash_tpu_torch.liveplot.liveplot_cb", no_live_plot)
    with profiling_on():
        mcmc.fit([TRAIN], HELD_OUT, **FIT)
    rec = profiling.last_fit()
    assert [c.counts["host_syncs"] for c in rec.calls()] == [2, 2]
    assert not rec.named("phlash.call.readback")


@contextlib.contextmanager
def profiling_on():
    "torch's profiler recording, CPU only, with no trace written."
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        yield


def test_upload_bytes_are_the_arrays_uploaded(untraced):
    "upload_bytes: the training chunks (rows and warm-ups) and the held-out ones, byte for byte."
    rec = untraced[1]
    _, chunks = init_mcmc_data([TRAIN], 100, FIT["overlap"], FIT["chunk_size"])
    held = chunk_het_matrix(HELD_OUT.het_matrix[:20], overlap=FIT["overlap"],
                            chunk_size=FIT["chunk_size"])
    uploads = rec.named("phlash.start.upload")
    assert [s.counts["upload_bytes"] for s in uploads] == [
        chunks[:, :4].nbytes, chunks[:, 4:].nbytes, held[:, 4:].nbytes, held[:, :4].nbytes]
    assert rec.spans[0].counts["upload_bytes"] == chunks.nbytes + held.nbytes


class _Stream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


class _Graph:
    def replay(self):
        pass


def test_capture_span_is_setup_seconds(monkeypatch):
    """Caller._capture's phlash.capture span and Caller.setup_seconds come
    from the same stamps (torch.cuda's graph calls stubbed on the CPU)."""
    for name, value in [("graph_pool_handle", lambda: None), ("Stream", _Stream),
                        ("current_stream", lambda *a: None),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("synchronize", lambda *a: None), ("CUDAGraph", _Graph),
                        ("graph", lambda *a, **k: contextlib.nullcontext())]:
        monkeypatch.setattr(torch.cuda, name, value)
    p = torch.randn(4, 3)
    caller = training.Caller(lambda state, inds: SVGDState(state.particles + 1.0,
                                                             state.opt_state))
    caller.state = SVGDState(particles=p, opt_state=AMSGrad(0.1).init(p))
    key = (2, False)
    profiling.records_fit(caller._capture)(key, torch.zeros(2, 1, dtype=torch.long), None)
    rec = profiling.last_fit()
    (sp,) = rec.named("phlash.capture")
    secs = caller.setup_seconds[key]
    assert sp.attrs == {"key": key, "warmup_s": secs["warmup"], "capture_s": secs["capture"]}
    assert sp.seconds == pytest.approx(secs["warmup"] + secs["capture"], abs=1e-9)
    assert rec.setup_seconds == sp.seconds


def test_a_raising_callback_leaves_the_record_closed_and_whole():
    "The callback's error propagates; the record is closed, every span ended, its call cut apart."
    def boom(dm):
        if profiling.last_fit().call == 1:
            raise RuntimeError("boom")

    with profiling_on(), pytest.raises(RuntimeError, match="boom"):
        mcmc.fit([TRAIN], HELD_OUT, callback=boom, **FIT)
    rec = profiling.last_fit()
    assert rec.closed and all(s.end is not None for s in rec.spans)
    raised = [s.name for s in rec.spans if s.raised]
    assert raised == ["phlash.fit", "phlash.call", "phlash.call.user_callback"]
    assert [c.call for c in rec.calls()] == [0] and rec.count_per_call("host_syncs") == 3.0


def test_a_direct_ingest_leaves_the_last_fit_alone(untraced):
    "init_mcmc_data called outside a fit records nothing."
    before = profiling.last_fit()
    n = len(before.spans)
    init_mcmc_data([TRAIN, HELD_OUT], 100, FIT["overlap"], FIT["chunk_size"], num_workers=1)
    assert profiling.last_fit() is before and len(before.spans) == n


def test_the_chrome_trace_names_the_spans(traced):
    "profiling.trace around a fit writes every span of the fit's calls into its Chrome trace."
    names = _names(traced[2])
    assert CALL_CHILDREN | {"phlash.call", "phlash.start", "phlash.start.ingest"} <= names


@pytest.mark.parametrize("name", READERS)
def test_the_benchmarks_readers_read_the_record(traced, name):
    "Each of the benchmark's span and counter readers gets a number from a traced CPU fit."
    value = traced[3][name]
    assert isinstance(value, float)
    if name == "syncs_per_call":
        assert value == 3.0
    elif name == "capture_s":
        assert value == 0.0  # no CUDA graph on the CPU
    elif name in ("hmm_fix_share", "hmm_trim_share"):
        assert value == 0.0  # the plain versions split nothing and count no trim
    else:
        assert value > 0


def test_the_record_carries_the_split_kernels_device_counts(untraced, traced, monkeypatch):
    """Each fit's record closes with the four device counts of the SMC'
    kernels' split launches, the two of their live ends and the split
    adjoint's two host tallies (zeros on the CPU, where nothing splits or
    trims on a card), read when the fit ends,
    also by an exception; reset at each fit's start.  Beside them the
    packed kernels' device counts and work tallies, zeros on this smc fit,
    and the checkpoint writer's counters, zeros on a fit without checkpoints."""
    from phlash_tpu_torch import checkpoint
    from phlash_tpu_torch.ops import packed, smc

    want = dict.fromkeys(smc.DEVICE_COUNTS + smc.TRIM_COUNTS + smc.SPLIT_COUNTS
                         + packed.DEVICE_COUNTS + packed.WORK_COUNTS + checkpoint.SAVE_COUNTS, 0)
    assert smc.SPLIT_COUNTS == ("smc_adjoint_split_launches", "smc_adjoint_split_warps")
    assert set(smc.DEVICE_COUNTS) == {"smc_segments", "smc_segments_resolved", "smc_fix_sites",
                                      "smc_split_sites"}
    assert smc.TRIM_COUNTS == ("smc_trimmed_sites", "smc_row_sites")
    assert untraced[1].counts == want and traced[1].counts == want
    resets = []
    monkeypatch.setattr(smc.device_tally, "reset", lambda: resets.append(1))

    def stop(dm):
        raise RuntimeError("stop")

    with pytest.raises(RuntimeError, match="stop"):
        mcmc.fit([TRAIN], HELD_OUT, callback=stop, **FIT)
    rec = profiling.last_fit()
    assert resets == [1] and rec.closed and rec.counts == want


def test_hmm_trim_share_reads_none_without_the_trim_counts(monkeypatch):
    """benchmark/metrics/hmm_trim_share.py reads None where the newest fit's
    record holds no live-end counts (a program without them, or no fit),
    and the share of the rows' instance-sites past their live ends where it
    does."""
    for rec in (None, SimpleNamespace(counts={}),
                SimpleNamespace(counts={"smc_fix_sites": 3, "smc_split_sites": 9})):
        monkeypatch.setattr(profiling, "last_fit", lambda rec=rec: rec)
        assert _read("hmm_trim_share") is None
    for counts, want in (({"smc_trimmed_sites": 3, "smc_row_sites": 12}, 25.0),
                         ({"smc_trimmed_sites": 0, "smc_row_sites": 0}, 0.0)):
        monkeypatch.setattr(profiling, "last_fit", lambda c=counts: SimpleNamespace(counts=c))
        assert _read("hmm_trim_share") == want


def test_packed_fix_share_reads_none_without_the_packed_counts(monkeypatch):
    """benchmark/metrics/packed_fix_share.py reads None where the newest fit's
    record holds no packed device counts (a program without them, or no
    fit), and the share of split sites that fix chains ran where it does."""
    for rec in (None, SimpleNamespace(counts={}),
                SimpleNamespace(counts={"smc_fix_sites": 3, "smc_split_sites": 9})):
        monkeypatch.setattr(profiling, "last_fit", lambda rec=rec: rec)
        assert _read("packed_fix_share") is None
    rec = SimpleNamespace(counts={"packed_fix_sites": 3, "packed_split_sites": 12})
    monkeypatch.setattr(profiling, "last_fit", lambda: rec)
    assert _read("packed_fix_share") == 25.0
