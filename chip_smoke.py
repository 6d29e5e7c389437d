#!/usr/bin/env python3
"""On-card smoke test of phlash_tpu_torch: build, check and drive the CUDA path.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # the whole check (needs one card)
    python3 chip_smoke.py --profile  # also print a torch.profiler table of SVGD steps

Phases, each of which prints its own lines and aborts the run on failure:
1. device: the card's name and `nvidia-smi` name / power limit;
2. build: nvcc builds the kernels from phlash_tpu_torch/csrc;
3. kernels against their plain PyTorch versions (float64 on the card), with
   a missing block and a padded tail: at a ragged shape for every M, and at
   the fit's likelihood (L=2000) and warm-up filter (L=500) shapes;
4. the slice: phlash_tpu_torch.psmc on a seeded .psmcfa at 500 particles,
   S=5, chunks of 2000 + 500 overlap, 30 iterations, with the launch counters
   showing that only the CUDA kernels ran; then ms per SVGD iteration;
5. kernel and plain times at the fit shape B=500, S=5, L=2000.
The last two lines are a JSON summary of the kernels and the result line.
It exits non-zero, printing no result, without a CUDA device or when the
package is not beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20240601
FWD_SRC = "phlash_tpu_torch/csrc/smc_forward.cu"
BWD_SRC = "phlash_tpu_torch/csrc/smc_backward.cu"
PATTERNS = {8: "8*1", 16: "14*1+1*2", 32: "32*1", 64: "64*1"}


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def random_instances(torch, M, B, S, L, dev, gen):
    """Per-particle params from the port's own assembly (perturbed
    coordinates), random per-instance pi, and int8 rows with a missing block
    and a padded tail; everything float64."""
    from phlash_tpu_torch.params import MCMCParams, PSMCParams
    from phlash_tpu_torch.utils import Pattern

    pat = PATTERNS[M]
    base = MCMCParams.from_linear(pattern=pat, t1=1e-4, tM=15.0, c=[1.0] * len(Pattern(pat)),
                                  theta=1e-2, rho=1e-2, device=dev)
    x0 = base.flatten()
    flat = x0 + 0.3 * torch.randn(B, x0.shape[-1], generator=gen, device=dev, dtype=x0.dtype)
    pp = PSMCParams.from_dm(base.unflatten(flat).to_dm())
    params = tuple(getattr(pp, k).contiguous() for k in ("b", "d", "u", "v", "emis0", "emis1"))
    w = torch.rand(B, S, M, generator=gen, device=dev, dtype=torch.float64) + 0.5
    pi = (pp.pi[:, None, :] * w) / (pp.pi[:, None, :] * w).sum(-1, keepdim=True)
    obs = (torch.rand(S, L, generator=gen, device=dev) < 0.05).to(torch.int8)
    obs[1 % S, L // 5: L // 5 + 100] = -1  # missing block
    obs[2 % S, L - L // 10:] = -2  # padded tail
    return params, pi.contiguous(), obs


def max_rel(a, b, atol=1e-25):
    return float(((a.double() - b).abs() / (b.abs() + atol)).max())


# (B, S, L, Ms) of the phase-3 checks: a ragged shape (B*S within one block,
# L a multiple of 8) for every M, then the fit's two shapes at M=16: the
# likelihood (L=2000) and the warm-up filter (L=500, whose last period holds
# 4 live sites), 2500 instances over 20 blocks.
CHECK_SHAPES = ((37, 3, 1000, (8, 16, 32, 64)), (500, 5, 2000, (16,)), (500, 5, 500, (16,)))


def check_kernels(torch, smc, dev):
    """Phase 3: each kernel against its plain version (float64 on the card),
    and the plain forward against the per-site scan oracle (hmm.psmc_ll).
    Returns, per kernel, the largest absolute error and the largest errors in
    the form their gates read (relative for the forward's ll and states,
    normalized for the adjoint's gradients)."""
    from phlash_tpu_torch.hmm import psmc_ll
    from phlash_tpu_torch.params import PSMCParams

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"forward": {"abs": 0.0, "ll": 0.0, "state": 0.0}, "backward": {"abs": 0.0, "grad": 0.0}}
    for B, S, L, Ms in CHECK_SHAPES:
        for M in Ms:
            where = f"M={M} B={B} S={S} L={L}"
            params, pi, obs = random_instances(torch, M, B, S, L, dev, gen)
            f32 = lambda xs: tuple(x.float().contiguous() for x in xs)  # noqa: E731
            ll_k, a_k, ps_k = smc.forward_cuda(f32(params), pi.float(), obs, True)
            torch.cuda.synchronize()
            ll_p, a_p, ps_p = smc.forward_structured(params, pi, obs, True)
            pp = PSMCParams(*(x[:, None, :] for x in params), pi=pi)
            a_o, ll_o = psmc_ll(pp, obs)
            e_o = max(max_rel(ll_p, ll_o), max_rel(a_p, a_o))
            e_ll, e_a, e_ps = max_rel(ll_k, ll_p), max_rel(a_k, a_p), max_rel(ps_k, ps_p)
            print(f"forward {where}: max rel err ll {e_ll:.3e} alpha {e_a:.3e} "
                  f"pstates {e_ps:.3e}; plain vs psmc_ll {e_o:.3e}")
            if not e_o <= 1e-10:
                fail(f"the plain forward disagrees with hmm.psmc_ll at {where}")
            if not (e_ll <= 1e-5 and e_a <= 1e-4 and e_ps <= 1e-4):
                fail(f"forward kernel disagrees with the plain version at {where}")
            fwd = errs["forward"]
            fwd["ll"], fwd["state"] = max(fwd["ll"], e_ll), max(fwd["state"], e_a, e_ps)
            fwd["abs"] = max(fwd["abs"], float((ll_k.double() - ll_p).abs().max()),
                             float((a_k.double() - a_p).abs().max()))

            gbar = torch.randn(B, S, generator=gen, device=dev, dtype=torch.float64)
            abar0 = torch.randn(B, S, M, generator=gen, device=dev, dtype=torch.float64)
            g_k, dpi_k = smc.backward_cuda(f32(params), obs, ps_k, gbar.float(), abar0.float())
            torch.cuda.synchronize()
            g_p, dpi_p = smc.backward_structured(params, obs, ps_p, gbar, abar0)
            names = ("b", "d", "u", "v", "emis0", "emis1", "pi")
            bwd = errs["backward"]
            worst = 0.0
            for name, a, b in zip(names, (*g_k, dpi_k), (*g_p, dpi_p)):
                err = float((a.double() - b).abs().max())
                norm = err / (float(b.abs().max()) + 1e-12)
                worst = max(worst, norm)
                bwd["abs"] = max(bwd["abs"], err)
                if not norm <= 2e-5:
                    fail(f"adjoint kernel disagrees on d{name} at {where}: "
                         f"normalized err {norm:.3e}")
            bwd["grad"] = max(bwd["grad"], worst)
            print(f"backward {where}: max normalized err over the 7 gradients {worst:.3e}")
    return errs


def write_psmcfa(path: Path, n_contigs=4, windows=100_000):
    import numpy as np

    rng = np.random.default_rng(SEED)
    with open(path, "w") as f:
        for k in range(n_contigs):
            het = rng.random(windows) < 0.05
            seq = np.where(het, "K", "T")
            f.write(f">chr{k + 1}\n")
            for lo in range(0, windows, 60):
                f.write("".join(seq[lo: lo + 60]) + "\n")


def run_slice(torch, smc, dev, path: Path):
    "Phase 4: the fit path through the public entry point."
    import phlash_tpu_torch

    kw = dict(num_particles=500, minibatch_size=5, chunk_size=2000, overlap=500)
    smc.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    models = phlash_tpu_torch.psmc([str(path)], device="cuda", niter=30, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = smc.counts()
    print(f"slice: psmc(niter=30) took {wall:.2f} s; launch counts {counts}")
    if counts["forward_cuda"] == 0 or counts["backward_cuda"] == 0:
        fail("the fit did not launch both CUDA kernels")
    if counts["forward_plain"] or counts["backward_plain"]:
        fail("a plain version ran on the CUDA path")
    if len(models) != 500:
        fail(f"expected 500 models, got {len(models)}")
    for m in models:
        if not (torch.isfinite(m.eta.t).all() and torch.isfinite(m.eta.c).all()
                and (m.eta.c > 0).all() and m.rho == m.rho):
            fail("a returned model is not finite")
    Ne = torch.stack([0.5 / m.eta.c for m in models])
    print(f"slice: 500 finite models; median Ne(t) over particles at M epochs: "
          f"{[f'{x:.4g}' for x in Ne.median(0).values.tolist()]}")
    return counts


def step_timing(torch, dev, path: Path, profile: bool):
    "ms per SVGD iteration after warm-up, on the same data as the slice."
    from phlash_tpu_torch.data import RawContig, init_mcmc_data
    from phlash_tpu_torch.training import build_training

    contigs = list(RawContig.from_psmcfa_iter(str(path), 100))[1:]
    afs, chunks = init_mcmc_data(contigs, 100, 500, 2000)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prog = build_training(chunks, afs, window_size=100, overlap=500, device=dev, generator=gen,
                          options=dict(num_particles=500, minibatch_size=5, niter=30))
    state = prog.state
    for _ in range(3):
        state = prog.step(state)
    torch.cuda.synchronize()
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        state = prog.step(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    print(f"svgd step: {ms:.3f} ms/iter (500 particles, S=5, chunk 2000 + 500, mean of {n})")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            for _ in range(5):
                state = prog.step(state)
            torch.cuda.synchronize()
        print(p.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    return ms


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_timing(torch, smc, dev):
    "Phase 5: each kernel and its plain version at the fit shape, float32."
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, S, L, M = 500, 5, 2000, 16
    params, pi, obs = random_instances(torch, M, B, S, L, dev, gen)
    obs[obs == -2] = 0  # the fit's rows carry no padding
    params = tuple(x.float().contiguous() for x in params)
    pi = pi.float().contiguous()
    gbar = torch.randn(B, S, generator=gen, device=dev)
    abar0 = torch.randn(B, S, M, generator=gen, device=dev)
    _, _, ps = smc.forward_cuda(params, pi, obs, True)
    _, _, ps_p = smc.forward_structured(params, pi, obs, True)
    t = {
        "fwd": time_ms(torch, lambda: smc.forward_cuda(params, pi, obs, False), 20),
        "fwd_plain": time_ms(torch, lambda: smc.forward_structured(params, pi, obs, False), 2),
        "bwd": time_ms(torch, lambda: smc.backward_cuda(params, obs, ps, gbar, abar0), 20),
        "bwd_plain": time_ms(
            torch, lambda: smc.backward_structured(params, obs, ps_p, gbar, abar0), 2),
    }
    t["fwd_grad"] = time_ms(torch, lambda: smc.backward_cuda(
        params, obs, smc.forward_cuda(params, pi, obs, True)[2], gbar, abar0), 20)
    t["fwd_grad_plain"] = time_ms(torch, lambda: smc.backward_structured(
        params, obs, smc.forward_structured(params, pi, obs, True)[2], gbar, abar0), 2)
    sites = B * S * L
    print(f"timing at B={B} S={S} L={L} M={M} (float32):")
    print(f"  forward alone     kernel {t['fwd']:.4f} ms   plain {t['fwd_plain']:.2f} ms"
          f"   kernel {sites / t['fwd'] / 1e3:.1f} Msites/s")
    print(f"  adjoint alone     kernel {t['bwd']:.4f} ms   plain {t['bwd_plain']:.2f} ms")
    print(f"  forward + adjoint kernel {t['fwd_grad']:.4f} ms   plain {t['fwd_grad_plain']:.2f} ms"
          f"   kernel {sites / t['fwd_grad'] / 1e3:.1f} Msites/s")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"  launch geometry: {B * S} threads = {-(-B * S // 32)} warps in "
          f"{-(-B * S // 128)} blocks of 128 on {sms} SMs")
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="profile 5 SVGD steps")
    args = ap.parse_args()
    if not (ROOT / "phlash_tpu_torch" / "csrc").is_dir():
        fail(f"phlash_tpu_torch/ not found beside {Path(__file__).name}; run from a checkout")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this check needs a CUDA device")

    # 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi.stdout.strip())  # name, power limit

    # 2. build
    from phlash_tpu_torch.ops import build, smc

    lib = build.load_library()
    print(f"build: {lib.path.name} in {lib.build_seconds:.1f} s")
    for line in lib.ptxas_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernels against their plain versions
    errs = check_kernels(torch, smc, dev)

    # 4. the slice
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke-") as tmp:
        path = Path(tmp) / "smoke.psmcfa"
        write_psmcfa(path)
        counts = run_slice(torch, smc, dev, path)
        step_ms = step_timing(torch, dev, path, args.profile)

    # 5. kernel times at the fit shape
    t = kernel_timing(torch, smc, dev)

    if "jax" in sys.modules or "phlash_tpu" in sys.modules:
        fail("JAX or phlash_tpu was imported")
    print(f"svgd_step_ms_per_iter: {step_ms:.3f}")
    print(json.dumps({"kernels": [
        {"name": "smc_forward", "route": "cuda", "source": FWD_SRC,
         "replaces": "phlash_tpu/ops/pallas_smc.py:358", "launches": counts["forward_cuda"],
         "max_abs_err": errs["forward"]["abs"], "max_rel_err_ll": errs["forward"]["ll"],
         "max_rel_err_alpha_pstates": errs["forward"]["state"],
         "gate": "rel: ll 1e-5, alpha and pstates 1e-4",
         "ms": t["fwd"], "plain_ms": t["fwd_plain"]},
        {"name": "smc_backward", "route": "cuda", "source": BWD_SRC,
         "replaces": "phlash_tpu/ops/pallas_smc.py:511", "launches": counts["backward_cuda"],
         "max_abs_err": errs["backward"]["abs"], "max_normalized_err": errs["backward"]["grad"],
         "gate": "max|err| / max|plain| per gradient 2e-5",
         "ms": t["bwd"], "plain_ms": t["bwd_plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
