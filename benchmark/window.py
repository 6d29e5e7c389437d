"""The measured window: one call of the cell's entry (phlash_tpu_torch.fit), stopped from its callback.

The entry (benchmark/entries/<entry>.py) calls the harness's callback after
every call of steps_per_call SVGD iterations, with the cloud read back to
the host.  The callback notes the host time, keeps the first call's
outputs for the correctness check (the cloud, and what the entry's
`observe` reads from the callback's caller), starts and stops the profiler
of a traced run, and once `seconds` have passed since the entry was called
raises WindowClosed, which `Window.run` catches.  So the window holds all
that fit does: ingestion, chunking, upload, the program's build, the
held-out ELPD's set-up, the graph's warm-up and capture, and then the loop.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

from benchmark.tracing import Profiler


class WindowClosed(Exception):
    "Raised by the harness's callback to end the fit."


@dataclass
class FirstCloud:
    "The cloud after fit's first call, as its callback got it (per-window units)."

    t: object  # (P, M) time grid
    c: object  # (P, M) coalescence rates
    rho: object  # (P,)
    theta: float
    seen: dict = field(default_factory=dict)  # what the entry's observe read (the ELPD)


class Window:
    """`run(fit, ...)` calls fit and returns when the window closes.

    seconds: the window's length from the call of fit (0: close at the
    first callback).  profile: None, or (skip, seconds): start the profiler
    at callback skip + 1 and stop it, and close the window, at the first
    callback `seconds` later."""

    def __init__(self, seconds: float, spc: int, profile: tuple[int, float] | None = None,
                 observe=None):
        self.seconds, self.spc, self.profile, self.observe = seconds, spc, profile, observe
        self.times: list[float] = []
        self.t_call = None
        self.first: FirstCloud | None = None
        self.profiler: Profiler | None = None
        self._prof_at = 0

    def callback(self, dm) -> None:
        now = time.perf_counter()
        self.times.append(now)
        if self.first is None:
            seen = {} if self.observe is None else self.observe(sys._getframe(1))
            self.first = FirstCloud(t=dm.eta.t.clone(), c=dm.eta.c.clone(),
                                    rho=dm.rho.clone(), theta=float(dm.theta), seen=seen)
        n = len(self.times)
        if self.profile is not None:
            skip, seconds = self.profile
            if self.profiler is None and n == skip + 1:
                self.profiler = Profiler(self.spc)
                self.profiler.start()
                self._prof_at = n
            elif self.profiler is not None and now - self.profiler.t0 >= seconds:
                self.profiler.stop(n - self._prof_at)
                raise WindowClosed
        if now - self.t_call >= self.seconds:
            if self.profiler is not None and self.profiler.trace is None:
                self.profiler.stop(n - self._prof_at)
            raise WindowClosed

    def run(self, call) -> None:
        "call(callback) runs the entry; returns when the window closes."
        self.t_call = time.perf_counter()
        try:
            call(self.callback)
        except WindowClosed:
            return  # the traceback, which holds fit's frames and graphs, goes with the exception
        raise RuntimeError("fit returned before the window closed: raise niter")

    @property
    def fit_start_s(self) -> float:
        "Host seconds from calling fit to its first callback."
        return self.times[0] - self.t_call

    @property
    def iters(self) -> int:
        "SVGD iterations between the first callback and the last."
        return self.spc * (len(self.times) - 1)

    @property
    def iters_per_s(self) -> float:
        "Those iterations over the host time between those two callbacks."
        if len(self.times) < 2:
            raise RuntimeError("the window closed before a second callback: lengthen it")
        return self.iters / (self.times[-1] - self.times[0])
