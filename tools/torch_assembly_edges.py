#!/usr/bin/env python3
"""Where the assembly kernels' float32 gradient departs from its plain version, on one card.

    python tools/torch_assembly_edges.py [--fmad-false]

Runs chip_smoke.py's phase 3c (`check_assembly`: every case printed, and
whether the gates held), then rebuilds its cloud at the fit's shape (500
particles, pattern 14*1+1*2; chip_smoke.edges_cases, whose one-ulp gate
phase 3c also reads) and, at n - 1 = 0, 1 and 8, prints for each
of the six edge particles (chip_smoke.assembly_cloud) the float32
gradient's error against the plain float64 version, A2's and the plain
version's, both over the edge particles' max|grad|, and the plain float32
gradient's one-ulp spread (chip_smoke.ulp_spread: the largest change when
one input coordinate moves by one ulp, up or down); for the other particles also
where A2's largest error lies and the plain float32 version's error on
the CPU.
With --fmad-false every kernel is built with nvcc's --fmad=false (no
contracted multiply-adds; a library of its own), to see whether
contraction is what separates the kernel from the plain version.  Needs
one CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fmad-false", action="store_true")
    args = ap.parse_args()
    import torch

    from phlash_tpu_torch.ops import assembly, build

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    if args.fmad_false:
        build.NVCC_FLAGS = (*build.NVCC_FLAGS, "--fmad=false")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    print(f"nvcc flags: {' '.join(build.NVCC_FLAGS)}")
    build.load_library()
    try:
        cs.check_assembly(torch, dev)
        print("phase 3c: passed")
    except SystemExit:
        print("phase 3c: failed (above)")

    for nm1, init, x, afs, T, g in cs.edges_cases(torch, dev):
        want = assembly.assemble_vjp_plain(init, x, afs, T, *g)
        i32, x32 = init.to(dtype=torch.float32), x.float().contiguous()
        a32 = None if afs is None else afs.float()
        T32 = None if T is None else T.float().contiguous()
        g32 = [t.float().contiguous() for t in g]
        plain = assembly.assemble_vjp_plain(i32, x32, a32, T32, *g32).double()
        kernel = assembly.backward_cuda(i32, x32, a32, T32, *g32).double()
        spread = cs.ulp_spread(torch, i32, x32, a32, T32, g32)[1].double().amax(-1)
        torch.cuda.synchronize()
        scale = float(want[:cs.N_EDGE].abs().max())
        print(f"n-1={nm1}: edge particles' max|grad| {scale:.3e}")
        for i in range(cs.N_EDGE):
            k_err = float((kernel[i] - want[i]).abs().max()) / scale
            p_err = float((plain[i] - want[i]).abs().max()) / scale
            print(f"  edge particle {i}: max|grad| {float(want[i].abs().max()):.3e}; error A2 "
                  f"{k_err:.2e}, plain {p_err:.2e}; plain spread at one ulp "
                  f"{float(spread[i]) / scale:.2e}")
        # the other particles, and the plain float32 version on the CPU
        cpu = [None if t is None else t.cpu() for t in (x32, a32, T32, *g32)]
        plain_cpu = assembly.assemble_vjp_plain(i32.to(device="cpu"), *cpu).double().to(dev)
        rest = float(want[cs.N_EDGE:].abs().max())
        err = (kernel[cs.N_EDGE:] - want[cs.N_EDGE:]).abs()
        worst = divmod(int(err.argmax()), err.shape[1])
        print(f"  other particles: max|grad| {rest:.3e}; error A2 {float(err.max()) / rest:.2e} "
              f"(particle {worst[0] + cs.N_EDGE}, coordinate {worst[1]}), plain "
              f"{float((plain[cs.N_EDGE:] - want[cs.N_EDGE:]).abs().max()) / rest:.2e}, plain on "
              f"the CPU {float((plain_cpu[cs.N_EDGE:] - want[cs.N_EDGE:]).abs().max()) / rest:.2e}"
              f"; plain spread at one ulp {float(spread[cs.N_EDGE:].max()) / rest:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
