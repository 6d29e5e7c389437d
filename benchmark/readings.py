#!/usr/bin/env python3
"""The readings a cell's limits are set from, over many seeds in one process.

    python benchmark/readings.py --workload diploid.genome --seeds 11 12 13 \\
        [--numbers elpd_gap] [--variants tf32 bf16 half] [--seconds 3] \\
        [--leaves] [--out readings.jsonl]

For every seed, through the path that applies the limits (benchmark/run.py:
host_settings, set_up with its warm fit, measure, judge_window): the cell's
window for --seconds, then its check.  One JSON line a seed: the program's
numbers and `correct`, and for each variant the numbers and `correct` of
its outputs judged by the same check (benchmark/check.judge):
  tf32     the control: the reference in float32 with every product's
           operands rounded to TF32, in the program's place (its cloud
           after the call where density_gap is asked for, else the
           program's, and its held-out ELPD at that cloud)
  bf16     the same with bfloat16 operands
  f32      the same in float32
  jitter   the reference from the initial cloud moved by a few float32 ulps
  half     the fault "half of the batch left out, the mean over the rest":
           the SVGD direction averages over half of the particles
  shifted  the fault "an answer altered where it is produced": the
           likelihood reads each minibatch chunk's successor's body
(A state left unchanged reads 1 by construction.)  --numbers limits the
work to some of the compared numbers (elpd_gap needs no reference step);
--leaves adds the per-coordinate gaps of the change over the call.  The
benchmark's runs never run this; it runs on one CUDA device (--device).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import cells, check, run  # noqa: E402
from benchmark.reference import fit as reference  # noqa: E402
from benchmark.reference.hmm import Arith  # noqa: E402

ARITH = {"tf32": Arith(torch.float32, "tf32"), "bf16": Arith(torch.float32, "bf16"),
         "f32": Arith(torch.float32)}


def variant(ref: check.Reference, prog: check.Outputs, v: str) -> check.Outputs:
    "The outputs of variant v put in the program's place."
    pb = ref.pb
    follow = "density_gap" in ref.numbers
    if v in ARITH:
        cloud = reference.follow(pb, ARITH[v])[0].double() if follow else prog.cloud
        return check.Outputs(cloud=cloud, elpd=reference.elpd(pb, cloud, ARITH[v]))
    if v == "jitter":
        g = torch.Generator(device=pb.x0.device).manual_seed(1)
        x0 = pb.x0 * (1 + 2.0**-21 * torch.randn(pb.x0.shape, generator=g, device=pb.x0.device))
        cloud = reference.follow(dataclasses.replace(pb, x0=x0))[0]
    else:
        cloud = reference.follow(pb, fault=v)[0]
    return check.Outputs(cloud=cloud, elpd=reference.elpd(pb, cloud))


def leaves(ref: check.Reference, cloud: torch.Tensor) -> dict:
    """Per coordinate ("leaf"): the gap between the norm over particles of
    the program's change over the call and the reference's, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; leaves whose first reference gradient is under STILL of the
    median leaf's are left out."""
    n_prog = (cloud - ref.x0).norm(dim=0)
    n_ref = (ref.x_ref - ref.x0).norm(dim=0)
    gn = ref.g_ref.norm(dim=0)
    moving = gn >= check.STILL * gn.median()
    gaps = (n_prog - n_ref).abs() / torch.maximum(n_ref, n_ref[moving].median())
    return dict(change_gap=float(gaps[moving].max()), median_leaf_gap=float(gaps[moving].median()),
                leaves=gaps.tolist(), grad_norms=gn.tolist(),
                left_out=torch.nonzero(~moving).flatten().tolist())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--numbers", nargs="*", default=None, choices=check.NUMBERS)
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=("tf32", "bf16", "f32", "jitter", "half", "shifted"))
    ap.add_argument("--variant-seeds", type=int, default=None,
                    help="run the variants on the first this many seeds only")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--leaves", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = cells.load(args.workload, ROOT)
    run.host_settings()
    numbers = tuple(args.numbers or cell.limits)
    limits = {k: v for k, v in cell.limits.items() if k in numbers}
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        s = run.set_up(cell, seed, args.device)
        try:
            win, counts, _ = run.measure(s, args.seconds)
            t1 = time.perf_counter()
            correct, checks, ref, got = run.judge_window(s, win, counts, numbers)
        finally:
            s.close()
        line = dict(workload=args.workload, seed=seed, calls=len(win.times),
                    per_call=[b - a for a, b in zip(win.times, win.times[1:])],
                    reference_s=time.perf_counter() - t1,
                    program=dict(correct=correct, **got,
                                 launch_mismatch=checks["launch_mismatch"]["value"]))
        prog = run.outputs(win, ref.pb)
        line["program"]["elpd"] = prog.elpd
        if args.leaves and "density_gap" in numbers:
            line["program"].update(leaves(ref, prog.cloud))
        if args.variant_seeds is None or n < args.variant_seeds:
            for v in args.variants:
                out = variant(ref, prog, v)
                vgot = ref.numbers_of(out)
                ok, _ = check.judge(vgot, limits, 0)
                line[v] = dict(correct=ok, elpd=out.elpd, **vgot)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as f:
                f.write(json.dumps(line) + "\n")
        del ref, win
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
