#!/usr/bin/env python3
"""Sustained issue rates of one H100: the counterpart of `python tools/vpu_peak.py`.

    python tools/torch_sm_peak.py [--sass]

Runs chip_smoke.py's phase 10 (`peak_phase`) on its own: the micro-kernels
of phlash_tpu_torch/ops/peak.py (csrc/peak.cu: FFMA chains, shuffle chains,
the SMC' mix, FFMA and shuffle chains side by side; in the SMC' kernels'
layout, a column of 16 states on 4 lanes), first each against its plain
version, then over tools/vpu_peak.py's sweep of streams x unroll and mix's
plateau configurations in two regimes: the card filled (four waves of 64
warps on each of 132 SMs, blocks of 128 threads) and the SMC' kernels' own
geometry (320 one-warp blocks, ~2.4 warps an SM, as B1-B3 launch 315 at the
fit and bench shapes).  Each configuration: the best of 3 windows of 10
launches between CUDA events.  It prints each instance's registers and
spills, the card's name, power limit and SM clock before and after the
sweep, one line a kernel and regime with G warp-instructions/s at each
configuration and the best (with thread-operations/s and its shares of the
data-sheet FFMA, shuffle and issue ceilings, roofline.py), what B1-B3 would
take at the fit shape (B = 500, S = 5, L = 2000, M = 16) if they issued
their counted instructions (roofline.issue_per_site) at the measured mix
plateau of each regime, and the micro-kernel maximum.

--sass first disassembles the built library with cuobjdump and prints, for
each micro-kernel instance and for the SMC' kernels at M = 16, the
instructions of its largest innermost loop by opcode: per step against
ops/peak.py's count, per site against roofline.py's.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SMC_PERIOD = 8  # sites a period of the SMC' kernels' loops


# --- SASS ---------------------------------------------------------------------

_FUNC = re.compile(r"Function : (_Z\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)[.\s;]")
_TARGET = re.compile(r"BRA\S*\s+(0x[0-9a-f]+)")


def demangle(name: str) -> str:
    "kernel<int arguments> of a mangled template kernel's name (else the name)."
    m = re.match(r"_Z\d+(\w+?)I((?:Li\d+E)+)E", name)
    return f"{m.group(1)}<{', '.join(re.findall(r'Li(\d+)E', m.group(2)))}>" if m else name


def sass_loops(listing: str) -> dict:
    """{kernel: [opcode counts of each loop]} of a `cuobjdump -sass` listing.
    A loop is the instructions from a branch's target address to the
    branch, where the target comes first; its counts include "all", its
    "span" (first and last instruction) and "reuse", the operand-reuse flags
    its instructions carry (each saves a register-file read)."""
    funcs: dict = {}
    name = None

    def close():
        loops = []
        for at, target in branches:
            start = at_address.get(target)
            if start is not None and start <= at:
                counts: dict = {"all": at - start + 1, "span": (start, at),
                                "reuse": sum(reuse[start:at + 1])}
                for op in ops[start:at + 1]:
                    counts[op] = counts.get(op, 0) + 1
                loops.append(counts)
        funcs[demangle(name)] = loops

    for line in listing.splitlines():
        m = _FUNC.search(line)
        if m:
            if name is not None:
                close()
            name, ops, reuse, at_address, branches = m.group(1), [], [], {}, []
            continue
        m = _INSTR.search(line) if name is not None else None
        if m:
            at_address[int(m.group(1), 16)] = len(ops)
            ops.append(m.group(2))
            reuse.append(line.count(".reuse"))
            t = _TARGET.search(line)
            if m.group(2) == "BRA" and t:
                branches.append((len(ops) - 1, int(t.group(1), 16)))
    if name is not None:
        close()
    return funcs


def innermost(loops: list[dict]) -> dict | None:
    "The largest loop that holds no other loop."
    def holds(lp, o):
        return o["span"] != lp["span"] and lp["span"][0] <= o["span"][0] <= o["span"][1] <= \
            lp["span"][1]

    inner = [lp for lp in loops if not any(holds(lp, o) for o in loops)]
    return max(inner, key=lambda lp: lp["all"]) if inner else None


def _opcodes(lp: dict) -> str:
    ops = {k: v for k, v in lp.items() if k not in ("span", "all", "reuse")}
    return ", ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])) + \
        f"; operand-reuse flags {lp['reuse']}"


def sass_report(listing: str) -> list[str]:
    """Lines comparing each micro-kernel's step loop with ops/peak.py's count
    and the SMC' kernels' period loops at M = 16 with roofline.py's."""
    from phlash_tpu_torch import roofline
    from phlash_tpu_torch.ops import peak

    loops = sass_loops(listing)
    lines = []
    for which in peak.KINDS:
        for streams, unroll in peak.CONFIGS[which]:
            kernel = f"peak_kernel<{peak.KINDS.index(which)}, {streams}, {unroll}>"
            lp = innermost(loops.get(kernel, []))
            if lp is None:
                lines.append(f"sass {kernel}: no loop found")
                continue
            want = {k: v * unroll for k, v in peak.step_counts(which, streams).items()}
            lines.append(f"sass {which} s={streams} u={unroll}: loop of {lp['all']} "
                         f"instructions ({unroll} steps); counted FFMA {want.get('ffma', 0)}, "
                         f"SHFL {want.get('shfl', 0)}, FSEL {want.get('fsel', 0)}; SASS: "
                         f"{_opcodes(lp)}")
    for name in ("smc_forward", "smc_backward"):
        kernel = f"{name}_kernel<16, 4>"
        lp = innermost(loops.get(kernel, []))
        if lp is None:
            lines.append(f"sass {kernel}: no loop found")
            continue
        count, shfl = roofline._smc_lane_counts(name, 16)
        sites = SMC_PERIOD * max(1, round(lp.get("SHFL", 0) / (shfl * SMC_PERIOD)))
        lines.append(f"sass {kernel}: loop of {lp['all']} instructions over {sites} sites: "
                     f"{lp['all'] / sites:.2f} a lane-site (roofline.py counts {count:.2f}), "
                     f"SHFL {lp.get('SHFL', 0) / sites:.2f} (counted {shfl:.2f}); "
                     f"{_opcodes(lp)}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", action="store_true", help="count the built kernels' loops")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_sm_peak.py needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from phlash_tpu_torch.ops import build

    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    lib = build.load_library()
    print(f"build: {lib.path.name} in {lib.build_seconds:.1f} s")
    if args.sass:
        cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
        listing = subprocess.run([str(cuobjdump), "-sass", str(lib.path)], capture_output=True,
                                 text=True, timeout=600, check=True).stdout
        for line in sass_report(listing):
            print(line)
    chip_smoke.peak_phase(torch, torch.device("cuda", 0), lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
