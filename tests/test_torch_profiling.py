"""profiling.trace and StepMeter of the port on the CPU.

The counterpart of phlash_tpu/profiling.py: `trace` profiles a block with
torch.profiler and writes a Chrome trace under its log directory when the
block exits (phlash_tpu: jax.profiler); on the card the same file names
the CUDA kernels (chip_smoke.py phase 8c).
"""

import glob
import json
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from phlash_tpu_torch import profiling  # noqa: E402
from phlash_tpu_torch.profiling import StepMeter, trace  # noqa: E402


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
    "StepMeter counts the iterations of each call and converts to Msites/s (host clock)."
    meter = StepMeter(sites_per_step=2.5e6, _t0=100.0)
    meter.tick(10)
    meter.tick(3)
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: 102.0)
    assert meter.steps_per_sec == 6.5
    assert meter.msites_per_sec == pytest.approx(16.25)
    assert meter.summary().startswith("13 steps, 6.50 it/s, 16 Msites/s")
