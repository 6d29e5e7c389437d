#!/usr/bin/env python3
"""Time and profile the port's SVGD step on one card, two trees in turns.

    python tools/torch_step_turns.py PARENT_DIR CHANGE_DIR [--out FILE]

Each turn runs in its own process from one tree's root (parent, change,
change, parent) and imports that tree's phlash_tpu_torch; the measurement
is this repo's chip_smoke.py, the same for every turn.  A turn builds the
kernels and both fit programs of chip_smoke.py's phase 4 (`smc` at overlap
500 and `packed` at overlap 0: 500 particles, S = 5, chunks of 2000,
float32, the AFS term and the held-out ELPD), and for each reads
- ms an SVGD iteration on the host clock, eager (base_step) and graphed
  (calls of steps_per_call = 10), as phase 4c times them;
- chip_smoke.profile_steps over the graphed and the eager step: device
  time, kernels (hand kernels apart) and host launch calls an iteration,
  and the busy share, as `chip_smoke.py --profile` prints them.
Each turn prints one JSON line; --out also writes them to FILE.  Needs one
CUDA device; every process it starts is waited for.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"

TURN = r'''
import importlib.util, json, subprocess, sys, tempfile
from pathlib import Path
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", %r)
chip_smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(chip_smoke)
import torch
from phlash_tpu_torch.ops import build

dev = torch.device("cuda", 0)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, timeout=60).stdout.strip()
build.load_library()
out = dict(tree=str(Path(".").resolve()), card=smi, torch=torch.__version__)
with tempfile.TemporaryDirectory(dir=".", prefix=".smoke-") as tmp:
    path = Path(tmp) / "smoke.psmcfa"
    chip_smoke.write_psmcfa(path)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 6)
    for b, ov in chip_smoke.PATHS:
        prog = chip_smoke.build_program(torch, dev, path, b, ov)[0]
        eager = chip_smoke.time_eager(torch, prog, gen)[0]
        graphed = chip_smoke.time_graphed(torch, prog, gen)[0]
        out[b] = dict(eager_ms_per_iter=eager, graphed_ms_per_iter=graphed,
                      profile_graphed=chip_smoke.profile_steps(torch, prog, gen, b, True, False),
                      profile_eager=chip_smoke.profile_steps(torch, prog, gen, b, False, False))
print("TURN " + json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    lines = []
    for label, tree in (("parent", args.parent), ("change", args.change),
                        ("change", args.change), ("parent", args.parent)):
        proc = subprocess.run([sys.executable, "-c", TURN % (str(SMOKE),)], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        turn = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
        if proc.returncode != 0 or not turn:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            print(f"the {label} turn in {tree} failed ({proc.returncode})", file=sys.stderr)
            return 1
        line = dict(turn=label, **json.loads(turn[0][5:]))
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(ln) + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
