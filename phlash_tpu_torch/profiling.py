"""Throughput counter of the training loop.

Port of phlash_tpu/profiling.py:17-46: `StepMeter` tracks SVGD iterations
per second and HMM Msites per second on the host clock.  phlash_tpu's
`trace` (a jax.profiler block) waits for the periphery; `chip_smoke.py
--profile` runs torch.profiler over the port's steps.
"""

from __future__ import annotations

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
