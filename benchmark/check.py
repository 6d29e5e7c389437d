"""What decides `correct`: the numbers compared, each beside its limit.

The reference (benchmark/reference/) works the window's first call out
again from the seed and the harness's inputs.  The program's outputs of
that call (benchmark/entries/<entry>.py's `observe`) are judged against it:
- density_gap: the median over particles of |log density of the program's
  particle - of the reference's| over the median of |log density of the
  reference's particle - of the initial one|, the density (prior, HMM and
  AFS terms, reference/fit.density, in float64) on the chunks the call
  visited: the cloud after the call's iterations.  It is steady from seed
  to seed, and it fails a step left out, half of the batch left out and an
  answer altered (PERF.md).
- elpd_gap: |the held-out ELPD the call computed - the reference's ELPD at
  the program's own cloud| over the reference's, on the held-out chunks the
  fit evaluates (reference/fit.elpd, float64).  It judges the forward
  kernels' arithmetic at the cell's lengths apart from the step's
  trajectory: a lower precision fails it (PERF.md).
- launch_mismatch (limit 0): how far the window's launch counters lie from
  what the cell's schedule needs, summed over the counters.  The schedule
  is data: the traffic's iterations a call (steps_per_call) and ELPD
  cadence (elpd_every), and benchmark/launches/<kernel_backend>.json, the
  launches an iteration, an ELPD and a graph's warm-up take on each device;
  every counter it does not name (a plain version on the card, another
  backend's kernels) has to read 0.
A cell's limits are benchmark/limits/<cell>.json; PERF.md gives the
readings they were set from.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import torch

from benchmark.reference import model

HERE = Path(__file__).resolve().parent
NUMBERS = ("density_gap", "elpd_gap")  # the numbers a cell's limits may name
STILL = 1e-3  # readings.py: a leaf whose reference gradient is under this share of the median's


@dataclass
class Outputs:
    "What the window's first call produced, as the check reads it."

    cloud: torch.Tensor | None  # (P, D) float64 coordinates of the particles after the call
    elpd: float | None  # the held-out ELPD the call computed


def density_gap(d0, d_prog, d_ref) -> float:
    """The median over particles of |the program's cloud's log density - the
    reference's| over the median of |the reference's - the initial cloud's|:
    each (P,), on the call's own chunks (reference/fit.density)."""
    return float((d_prog - d_ref).abs().median() / (d_ref - d0).abs().median())


def elpd_gap(got: float | None, want: float) -> float:
    "|got - want| / |want|; infinite when the program handed no ELPD."
    if got is None or not math.isfinite(got):
        return math.inf
    return abs(got - want) / abs(want)


class Reference:
    """The reference's side of the check for problem pb, computed once and
    only as far as the numbers asked for need it (reference:
    benchmark/reference/fit)."""

    def __init__(self, pb, reference, numbers=NUMBERS):
        self.pb, self.reference, self.numbers = pb, reference, tuple(numbers)
        self.x0 = pb.x0.double()
        if "density_gap" in self.numbers:
            self.x_ref, self.g_ref = reference.follow(pb)
            self.d0 = reference.density(pb, self.x0)
            self.d_ref = reference.density(pb, self.x_ref)

    def numbers_of(self, out: Outputs) -> dict:
        "Each number asked for, of the outputs `out` (inf where out has no finite cloud)."
        finite = out.cloud is not None and bool(torch.isfinite(out.cloud).all())
        got = {}
        if "density_gap" in self.numbers:
            got["density_gap"] = (density_gap(self.d0, self.reference.density(self.pb, out.cloud),
                                              self.d_ref) if finite else math.inf)
        if "elpd_gap" in self.numbers:
            got["elpd_gap"] = (elpd_gap(out.elpd, self.reference.elpd(self.pb, out.cloud))
                               if finite else math.inf)
        return got


def judge(got: dict, limits: dict, mismatch: int) -> tuple[bool, dict]:
    """(correct, checks): each compared number with its limit, the launch
    mismatch last with the limit 0.  A number the limits name and `got`
    lacks reads inf."""
    checks = {name: {"value": got.get(name, math.inf), "limit": limit}
              for name, limit in limits.items()}
    checks["launch_mismatch"] = {"value": mismatch, "limit": 0}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def cloud_coordinates(first, pattern: str) -> torch.Tensor:
    "The particles' coordinates (P, D) of the cloud a callback got, in float64."
    f = lambda v: torch.as_tensor(v, dtype=torch.float64)  # noqa: E731
    return model.coordinates(f(first.t), f(first.c), f(first.rho), first.theta, pattern)


def launch_table(backend: str, root: Path = HERE) -> dict:
    "benchmark/launches/<backend>.json: the launches of one backend's fit."
    return json.loads((root / "launches" / f"{backend}.json").read_text())


def schedule(calls: int, spc: int, elpd_every: int) -> tuple[int, int, set]:
    """(iterations, ELPD evaluations, the distinct (iterations, with ELPD)
    calls) of a fit's first `calls` calls of spc iterations, the ELPD on the
    first call at or after every elpd_every-th iteration, as fit schedules it."""
    its = elpds = 0
    kinds, next_elpd = set(), 0
    for c in range(calls):
        i = c * spc
        want = i >= next_elpd
        if want:
            next_elpd = i + elpd_every
            elpds += 1
        its += spc
        kinds.add((spc, want))
    return its, elpds, kinds


def expected_launches(table: dict, device: str, calls: int, spc: int, elpd_every: int) -> dict:
    """The counters {module: {counter: n}} a fit stopped after `calls` calls
    should read: table[device]'s launches an iteration and an ELPD, times
    the schedule's, and each distinct call's graph warm-up (one eager
    iteration, and the ELPD where the call has one)."""
    side = table[device]
    its, elpds, kinds = schedule(calls, spc, elpd_every)
    warm = side.get("warmup_per_graph", {"iterations": 0, "elpd": 0})
    its += warm["iterations"] * len(kinds)
    elpds += warm["elpd"] * sum(1 for _, e in kinds if e)
    want: dict[str, dict[str, int]] = {}
    for per, n in (("per_iteration", its), ("per_elpd", elpds)):
        for name, k in side[per].items():
            mod, counter = name.split(".")
            row = want.setdefault(mod, {})
            row[counter] = row.get(counter, 0) + k * n
    return want


def launch_mismatch(counts: dict, want: dict) -> int:
    "Sum over every counter of |counted - expected| (a counter missing on one side counts whole)."
    total = 0
    for mod in set(counts) | set(want):
        c, w = counts.get(mod, {}), want.get(mod, {})
        total += sum(abs(c.get(k, 0) - w.get(k, 0)) for k in set(c) | set(w))
    return total
