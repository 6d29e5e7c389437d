"""The result line's keys, and a run that finds no card ends without one."""

import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

from benchmark import run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_line_has_the_keys_the_driver_reads(tiny, trace):
    cell = tiny("diploid.short_chunks", particles=8)
    out = run.run_cell(cell, 2**33 + 5, 5.0, trace, device="cpu")
    line = json.loads(json.dumps(run.result_line(out, "NVIDIA H100 80GB HBM3", 1)))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["checks"]) == set(cell.limits) | {"launch_mismatch"}
    assert all({"value", "limit"} <= set(c) for c in line["checks"].values())
    assert line["checks"]["launch_mismatch"]["value"] == 0
    if trace:
        # on the CPU only the host span reads something; the device readers return nothing
        assert set(line["metrics"]) == {"ingest_s", "fit_start_s"}
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"iters_per_s", "setup_s"}
        assert all(m["value"] > 0 for m in line["metrics"].values())
        assert line["attempted"] >= 10


def test_no_card_no_result():
    "Without a CUDA device the run exits non-zero and prints nothing on stdout: no CPU fallback."
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                           "diploid.genome", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA device" in proc.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    "On a card: a short window of the short-chunk cell, correct, with every end-to-end metric."
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                           "diploid.short_chunks", "--seed", "3", "--seconds", "12",
                           "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == {"iters_per_s", "setup_s"}
