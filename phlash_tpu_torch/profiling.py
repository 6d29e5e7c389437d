"""Throughput counter of the training loop, and a profiler block.

Port of phlash_tpu/profiling.py: `StepMeter` tracks SVGD iterations per
second and HMM Msites per second on the host clock; `trace` profiles a
block with torch.profiler (phlash_tpu: jax.profiler) and writes its trace
where TensorBoard's profiler plugin, chrome://tracing or Perfetto read it.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field


@dataclass
class StepMeter:
    """Running throughput over the training loop.

    sites_per_step: observation columns visited per SVGD iteration
        (= particles x minibatch x chunk length for the HMM term).
    setup_seconds: host seconds the loop spent warming up and capturing
        CUDA graphs (training.Caller.setup_seconds, summed; 0 on the CPU).
    """

    sites_per_step: float = 0.0
    setup_seconds: float = 0.0
    _t0: float = field(default_factory=time.perf_counter)
    _steps: int = 0

    def tick(self, n: int = 1) -> None:
        "Count n more SVGD iterations (a call of n steps)."
        self._steps += n

    @property
    def steps(self) -> int:
        "SVGD iterations counted so far (what an early-stopped fit ran)."
        return self._steps

    @property
    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0

    @property
    def msites_per_sec(self) -> float:
        return self.steps_per_sec * self.sites_per_step / 1e6

    def summary(self) -> str:
        return (
            f"{self._steps} steps, {self.steps_per_sec:.2f} it/s, "
            f"{self.msites_per_sec:.0f} Msites/s, graph set-up {self.setup_seconds:.3f} s"
        )


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Profile the enclosed block with torch.profiler, CPU and (where there
    is a card) CUDA activities, and write a Chrome trace
    `<host>_<pid>.<time>.pt.trace.json` under `log_dir` (default
    phlash_tpu_torch_trace in the temporary directory, /tmp unless TMPDIR
    says otherwise) when the block exits.  Yields log_dir."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "phlash_tpu_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
