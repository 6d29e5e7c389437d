"""torch.profiler over a stretch of the window, reduced to what the per-layer readers read.

The arithmetic of tools/torch_step_turns.py's profile (chip_smoke.py's
`profile_steps`): device time by kernel name from the profiler's CUDA
events, kernels counted apart from copies and fills; and, new here, the
union of device activity inside the traced window (busy seconds), the
idle gaps between, each labelled by the innermost host operation that
covers its middle, and the window's own ends, taken from two marks the
harness records at the profiler's start and stop.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

MARK = "benchmark.window_mark"
HMM_KERNELS = ("smc_forward_kernel", "smc_backward_kernel")  # B1 / B2, B3
NOT_KERNELS = ("Memcpy", "Memset")
SHORT_GAP_US = 10.0  # idle gaps shorter than this are one device op waiting on the next
SHORT_GAP = "between device ops (< 10 us)"


@dataclass
class Trace:
    window_s: float  # between the two marks
    busy_s: float  # union of device activity inside the window
    iters: int  # SVGD iterations whose calls ran inside the window
    calls: int
    device_s: dict[str, float] = field(default_factory=dict)  # by device op name
    kernels: int = 0  # kernel launches on the device (copies and fills apart)
    gaps: dict[str, float] = field(default_factory=dict)  # idle seconds by host op

    def seconds_of(self, names) -> float:
        return sum(s for n, s in self.device_s.items() if any(k in n for k in names))


class Profiler:
    """Started and stopped from the fit's callback: `start()` at one
    callback, `stop(calls)` at a later one, with the calls that ran between."""

    def __init__(self, spc: int):
        from torch.profiler import ProfilerActivity, profile

        self.spc = spc
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.trace: Trace | None = None
        self.t0 = None

    def _mark(self) -> None:
        import torch

        with torch.profiler.record_function(MARK):
            pass

    def start(self) -> None:
        self.prof.start()
        self._mark()
        self.t0 = time.perf_counter()

    def stop(self, calls: int) -> Trace:
        self._mark()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        self.trace = reduce(self.prof.events(), calls, self.spc, wall)
        return self.trace


def _union(intervals):
    "Merged [start, end) intervals of a list, sorted."
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, calls: int, spc: int, wall: float) -> Trace:
    "The Trace of a profile's events (microsecond stamps) for `calls` calls of spc iterations."
    from torch.autograd import DeviceType

    marks = sorted(e.time_range.start for e in events if e.name == MARK)
    if len(marks) < 2:  # no marks: the host's wall time and every event
        lo, hi = float("-inf"), float("inf")
        window_us = wall * 1e6
    else:
        lo, hi = marks[0], marks[-1]
        window_us = hi - lo
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    device_s = defaultdict(float)
    kernels = 0
    spans = []
    for e in on_card:
        a, b = e.time_range.start, e.time_range.end
        if b <= lo or a >= hi:
            continue
        device_s[e.name] += (b - a) / 1e6
        kernels += not e.name.startswith(NOT_KERNELS)
        spans.append((max(a, lo), min(b, hi)))
    busy = _union(spans)
    edges = [lo] + [x for s in busy for x in s] + [hi] if busy else []
    host = [e for e in events if e.device_type == DeviceType.CPU and e.name != MARK]
    h0 = np.array([e.time_range.start for e in host], dtype=float)
    h1 = np.array([e.time_range.end for e in host], dtype=float)
    gaps = defaultdict(float)
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a or a == float("-inf") or b == float("inf"):
            continue
        if b - a < SHORT_GAP_US:
            gaps[SHORT_GAP] += (b - a) / 1e6
            continue
        mid = (a + b) / 2
        around = np.flatnonzero((h0 <= mid) & (h1 >= mid))
        name = (host[around[np.argmin((h1 - h0)[around])]].name if len(around)
                else "no traced host op")
        gaps[name] += (b - a) / 1e6
    return Trace(window_s=window_us / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6,
                 iters=calls * spc, calls=calls, device_s=dict(device_s), kernels=kernels,
                 gaps=dict(gaps))


def breakdown(trace: Trace, top: int = 10) -> dict:
    "The device ops that took most time and the idle time by host op, at most `top` each."
    def first(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": first(trace.device_s), "idle_gaps": first(trace.gaps)}
