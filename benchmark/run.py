#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on one card and print its result line.

    python benchmark/run.py --workload diploid.genome --seed 7 --seconds 30 --trace 0

Set-up (counted in setup_s, each step logged on standard error): import
torch and the port, load the kernel library (phlash_tpu_torch/_build/ in
the checkout: the first run there builds it), make the cell's inputs from
--seed (benchmark/inputs/), and one warm fit on them stopped at its first
callback.  The window: the configuration's entry (benchmark/entries/fit.py:
phlash_tpu_torch.fit) on the same inputs with the cell's options, stopped
from its callback once --seconds have passed since the call
(benchmark/window.py).  With --trace 1 the profiler covers a
stretch of the window's calls, which then closes, and the per-layer
readers (benchmark/metrics/) read it, with a timed call of fit's ingestion.
Then the check (benchmark/check.py): the reference (benchmark/reference/)
works out the window's first call again, and the launch counters are held
to the cell's schedule.  The last line of standard output is one JSON
object; the numbers compared, each with its limit, end standard error.

The process and the spawn pool's workers run one host thread each
(OMP_NUM_THREADS=1, torch.set_num_threads(1)), and the objects set-up made
are frozen out of the garbage collector's passes (gc.freeze) before the
window: both are listed under each configuration's `assumed`.
benchmark/readings.py reads the limits' readings through set_up, measure
and judge_window, the path that applies them.

Exits 1 without a result when there is no CUDA device, when the card
count is under the cell's chips, or when jax, jaxlib, flax or phlash_tpu
(top-level module names, compared whole) were imported by the end.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "phlash_tpu")
OPS = ("smc", "packed", "assembly", "svgd")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    "The forbidden top-level names among sys.modules, compared whole."
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def counters() -> dict:
    from phlash_tpu_torch import ops

    return {name: getattr(ops, name).counts() for name in OPS}


def reset_counters() -> None:
    from phlash_tpu_torch import ops

    for name in OPS:
        getattr(ops, name).reset_counts()


def host_settings() -> None:
    """One host thread a process (this one and the spawn pool's, which
    inherit it): the host work between calls is then steadier from run to
    run (the configurations list it under `assumed`)."""
    import torch

    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)


@dataclass
class Session:
    "A cell set up at one seed: its inputs, options and shapes, after the warm fit."

    cell: object
    seed: int
    device: str
    data: object  # benchmark/inputs.Inputs
    opts: dict  # the entry's options
    sh: object  # benchmark/shapes.Shapes
    setup: dict  # seconds of each set-up step

    def window(self, seconds: float, profile=None):
        from benchmark.window import Window

        return Window(seconds, self.sh.spc, profile, observe=self.cell.entry.observe)

    def call(self, callback) -> None:
        self.cell.entry.call(self.data, self.seed, self.opts, self.device, callback)

    def close(self) -> None:
        "Let the collector walk set-up's objects again, and delete the files written."
        gc.unfreeze()
        self.data.close()


def set_up(cell, seed: int, device: str = "cuda") -> Session:
    """Set-up: the kernel library (CUDA), the inputs from the seed, the
    shapes, and one warm fit on them stopped at its first callback; then
    what set-up made is frozen out of the garbage collector's passes."""
    from benchmark import inputs, shapes

    setup = {}
    t = time.perf_counter()
    if device == "cuda":
        from phlash_tpu_torch.ops import build

        setup["kernel_library_build"] = build.load_library().build_seconds
    setup["kernel_library"] = time.perf_counter() - t
    t = time.perf_counter()
    data = inputs.make(cell.config, seed)
    setup["inputs"] = time.perf_counter() - t
    setup.update(data.seconds)
    try:
        opts = cell.fit_options()
        sh = shapes.resolve(data.ref, data.ref_test, opts, cell.traffic)
        opts["minibatch_size"] = sh.S
        s = Session(cell, seed, device, data, opts, sh, setup)
        t = time.perf_counter()
        s.window(0.0).run(s.call)
        setup["warm_fit"] = time.perf_counter() - t
    except BaseException:
        data.close()
        raise
    gc.collect()
    # what set-up made lives on: keep the collector's full passes in the
    # window from walking it (they paused single calls by tens of ms)
    gc.freeze()
    return s


def measure(s: Session, seconds: float, profile=None):
    "(the window, its launch counters, peak device bytes): the entry run for `seconds`."
    import torch

    win = s.window(seconds, profile)
    reset_counters()
    cuda = s.device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    win.run(s.call)
    gc.collect()
    peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
    return win, counters(), peak


def problem(s: Session):
    "The reference's problem of the window's first call (benchmark/reference/fit.prepare)."
    from benchmark.reference import fit as reference

    return reference.prepare(s.data.ref, s.opts, s.seed, s.device, k=s.sh.spc,
                             ref_test=s.data.ref_test)


def outputs(win, pb):
    "The first call's outputs as the check reads them (benchmark/check.Outputs)."
    from benchmark import check

    cloud = check.cloud_coordinates(win.first, pb.pattern).to(pb.x0.device)
    return check.Outputs(cloud=cloud, elpd=win.first.seen.get("elpd"))


def judge_window(s: Session, win, counts: dict, numbers=None):
    """(correct, checks, the reference, the numbers worked out): the window's first call against the
    reference, and its launch counters against the cell's schedule.
    numbers: the compared numbers to work out (default: every one the
    cell's limits name; one left out reads inf)."""
    from benchmark import check
    from benchmark.reference import fit as reference

    pb = problem(s)
    numbers = tuple(numbers or s.cell.limits)
    ref = check.Reference(pb, reference, numbers)
    got = ref.numbers_of(outputs(win, pb))
    want = check.expected_launches(s.cell.launches, s.device, len(win.times), s.sh.spc,
                                   int(s.cell.traffic["elpd_every"]))
    limits = {k: v for k, v in s.cell.limits.items() if k in numbers}
    correct, checks = check.judge(got, limits, check.launch_mismatch(counts, want))
    return correct, checks, ref, got


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """One run of `cell`; returns the result's parts (see main).  device
    "cpu" drives the same run on the kernels' plain versions (for tests)."""
    from phlash_tpu_torch.data import init_mcmc_data

    t_start = time.perf_counter() if t_start is None else t_start
    s = set_up(cell, seed, device)
    try:
        setup_s = time.perf_counter() - t_start
        log("setup steps (s): " + json.dumps({**s.setup, "setup_s": setup_s}))
        log(f"shapes: {json.dumps(vars(s.sh))}")
        traffic = cell.traffic
        profile = (traffic["trace_skip_calls"], traffic["trace_seconds"]) if trace else None
        win, counts, peak = measure(s, seconds, profile)
        log(f"window: {len(win.times)} calls, fit_start_s {win.fit_start_s}; "
            f"launches {json.dumps(counts)}")
        log(f"seconds between callbacks: {[b - a for a, b in zip(win.times, win.times[1:])]}")

        spans = {"fit_start": win.fit_start_s}
        if trace:
            opts = s.opts
            t = time.perf_counter()
            init_mcmc_data(s.data.train, opts["window_size"], opts["overlap"],
                           opts.get("chunk_size"), opts.get("max_samples", 20),
                           opts.get("num_workers"))
            spans["ingest"] = time.perf_counter() - t

        t = time.perf_counter()
        correct, checks, _, _ = judge_window(s, win, counts)
        log(f"reference: {time.perf_counter() - t:.1f} s")
        units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
        if trace:
            tr = win.profiler.trace if win.profiler is not None else None
            run = SimpleNamespace(trace=tr, shapes=s.sh, spans=spans)
            metrics = {name: {"value": v, "unit": units[name]}
                       for name, reader in cell.readers.items()
                       if (v := reader.read(run)) is not None}
        else:
            tr = None
            values = {"iters_per_s": win.iters_per_s, "setup_s": setup_s}
            metrics = {name: {"value": values[name], "unit": units[name]}
                       for name in (m["name"] for m in cell.end_to_end)}
        return dict(correct=correct, attempted=win.iters + s.sh.spc, failed=0, metrics=metrics,
                    peak=peak, trace=tr, checks=checks)
    finally:
        s.close()


def result_line(out: dict, kind: str, count: int) -> dict:
    """The result's JSON object from run_cell's parts: the keys the driver
    reads, `breakdown` in a traced run, and the numbers compared last."""
    from benchmark import tracing

    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": out["peak"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    tr = out["trace"]
    if tr is not None:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = tracing.breakdown(tr)
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import cells

    cell = cells.load(args.workload, ROOT)
    t = time.perf_counter()
    import torch

    log(f"setup: import torch {time.perf_counter() - t:.2f} s")
    host_settings()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 1
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    line = result_line(out, torch.cuda.get_device_name(0), cell.chips)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules were imported: {bad}: no result")
        return 1
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
