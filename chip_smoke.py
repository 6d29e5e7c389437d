#!/usr/bin/env python3
"""On-card smoke test of phlash_tpu_torch: build, check and drive the CUDA path.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # the whole check (needs one card)
    python3 chip_smoke.py --profile  # also print torch.profiler tables of SVGD steps

Phases, each of which prints its own lines and aborts the run on failure:
1. device: the card's name and `nvidia-smi` name / power limit;
2. build: nvcc builds the kernels from phlash_tpu_torch/csrc, one process
   per source;
3. the SMC' kernels (B1-B3) against their plain PyTorch versions (float64
   on the card), with a missing block and a padded tail: at a ragged shape
   for every M, at the fit's likelihood (L=2000) and warm-up filter (L=500)
   shapes, and at a ragged row over three observation tiles (L=2501);
   after phase 4c also on the smc fit's own late inputs;
3b. the packed kernels (B4, B5) against theirs, the same way, at ragged
   shapes (B=37, S=3, L=1000 and L=2501: three observation tiles, a
   partial last period) and the fit shape (B=500, S=5, L=2000), with the
   kernels' checkpoint period (which the library reports and
   ops/packed.DEFAULT_SEG must equal); after phase 4c also on the packed
   fit's own late inputs;
3c. the assembly kernels (A1 forward, A2 its gradient; ops/assembly.py)
   against their plain versions, at a ragged P = 37 for every M of PATTERNS
   at n - 1 = 0, 8 and 40 (both through the default AFS transform) and 15,
   and at the
   fit's P = 500, M = 16 also at the fit's n - 1 = 1 and the bench's 9,
   with six edge particles on the branches' thresholds: float64 values
   rtol 1e-10 (pi against max pi) and gradients 1e-8 of max|plain|;
   float32 finite and no worse than twice the plain float32 version's
   error against float64 (or 4 ulps), leaves 1e-4 relative, pi 1e-6
   absolute, the edge particles' gradient within 1e-4 of max|plain|; and,
   beside those rules, every float32 gradient within ULP_GATE = 16 times
   the plain float32 gradient's one-ulp spread of that gradient,
   coordinate by coordinate, here and on tools/torch_assembly_edges.py's
   draw of 500 particles;
4. the slice: phlash_tpu_torch.psmc on a seeded .psmcfa at 500 particles,
   S=5, chunks of 2000 + 500 overlap, 30 iterations (kernel_backend "smc"),
   by the default CUDA graph replays of steps_per_call = 10 iterations with
   the held-out ELPD fused into each call; the launch counters (which count
   replays) must show exactly the expected launches of the SMC' CUDA
   kernels and of A1 / A2 (expected_counts: every iteration one of each,
   every ELPD one A1) and nothing else;
4b. the same with kernel_backend="packed" and overlap 0: only the packed
   CUDA kernels and A1 / A2 run;
4c. ms per SVGD iteration of both paths, eager (base_step) and graphed
   (calls of 10), timed in turns (smc, packed, packed, smc), with each
   graph's warm-up and capture time;
4d. graphed against eager on both paths (and on the dense backend at a
   small shape): from one state and one set of index rows, one graphed
   10-iteration call with the ELPD against 10 eager base_steps and the
   eager ELPD: identical indices, particles and amsgrad moments and the
   ELPD within 1e-6 relative;
4e. checkpoint/resume on the card: psmc(niter=20, checkpoint_path=...,
   save_every=10), then the same with niter=30, against phase 4's
   uninterrupted niter=30 fit, within 1e-6 relative;
5. SMC' kernel (B1, B2, B3) times with their launch geometry, and plain
   times, at the fit shape B=500, S=5, L=2000, M=16; then B2 and B3 on the
   smc fit's own inputs (its initial particle cloud, and its particles
   after the timed steps);
5b. packed kernel (B4, B5) and plain times at the same shape, with the
   kernels' launch geometry, then the packed kernels on the packed fit's
   own inputs (its initial particle cloud, and its particles after the
   timed steps); then A1 and A2 and their plain times on the smc fit's
   500 particles and AFS term (and at n - 1 = 15), beside their bounds and
   the launch floor (a one-element add), with their launch geometry (lanes
   a particle, warps a block, shared memory) and ptxas registers / spills;
5c. the scan backend (hmm.ScanKernel, plain PyTorch, float32) against the
   smc backend through the hand kernels at B=8, S=2, L=500: ll rtol 1e-4,
   gradients at normalized error 2e-5;
6. posterior reproduction: phlash_tpu_torch.sim regenerates the dataset of
   tests/data/torch_posterior_fixture.json (two contigs of 6,000,000
   windows), phlash_tpu_torch.fit fits it on the card by graph replay with
   the fixture's options, once for each of the fixture's keys as the seed,
   on "smc" at overlap 500 and on "packed" at overlap 0, with exact launch
   counts, and repro.compare holds each path's pooled ensemble against the
   committed phlash_tpu.fit ensemble of the same overlap: tv of the medians
   <= 0.10 and each median inside the other's 95% band on >= 0.90 of the
   grid.  Each path's line also carries a hash of its ensemble (equal
   hashes across runs show the run-to-run determinism) and the gate's
   reading on the port's ensemble with planted biases (c of epochs 5-8
   times 1.2, 1.5, 2.0), the largest of which must fail the gate.
7. from genome files: phlash_tpu_torch.sim simulates two contigs (chr1,
   chr2) of 500,000 windows (50 Mb) of 8 diploids under the bottleneck;
   one record per window where any sample is het is written, with the
   port's writers, as a tabix-indexed .vcf.gz, a plain .vcf and a .bcf
   with .csi; contig() of chr1 from each form must give the planted het
   matrix and the records' AFS (n = 16) exactly, through the C tokenizer
   and the native BCF reader with no warning; phlash_tpu_torch.fit from
   the .vcf.gz (chr1 as its two arms, read by a spawn pool of 2 workers,
   chr2 held out) at 500 particles, chunks of 2000 + 500, 30 iterations
   by graph replay with the ELPD, with exact launch counts and finite
   particles; the AFS term of the initial cloud in float32 within 1e-5
   relative of float64; and `python -m phlash_tpu_torch fit` called
   in-process on the .vcf.gz (chr2 held out, 20 iterations, exact launch
   counts) writes a posterior of 500 models that load_posterior reads.
8. the multi-GPU path and the last of the periphery: (a) phase 4's two
   fits again with mesh=make_mesh(1), a (1, 1) mesh over NCCL whose
   collectives the CUDA graphs capture: the same exact launch counts,
   particles within 1e-6 relative of phase 4's (bitwise equality printed),
   the collective counter's calls and bytes, ms per graphed iteration in
   turns with the unsharded programs of phase 4c (unsharded, meshed,
   meshed, unsharded), and what NCCL says to two ranks on this one device;
   (b) sim.simulate_hmm at L = 10,000,000 under the bottleneck, timed, its
   het rate within 4 standard errors of its law and a path's state
   marginal and transition counts by chi-square (p > 1e-3), then the
   repo's canonical end-to-end drive on the port: three
   simulated contigs of 20,000 windows as .psmcfa, psmc(...) on the card,
   the posterior median of c in [0.5, 2]; (c) profiling.trace around one
   graphed call of the smc program: the trace file names the smc kernels.
9. the port's bench: `python -m phlash_tpu_torch bench` from the checkout's
   root in a subprocess (with a deadline), its JSON line echoed as
   `bench: ...`; the phase fails unless the line has a value, the bench's
   gate (smc kernels against their plain float64 version) is within ll
   1e-5 relative and gradients 2e-5 normalized, every timed window
   launched its hand kernels in proportion (B1 fwd-only, B2 + B3 fwd+grad,
   B4 / B5 the packed windows, A1 / A2 their own windows; the SVGD steps
   also A1 + A2 once an iteration) and nothing else, every roofline share
   and the smc kernels' issue and shuffle shares lie in (0, 1], and the
   card it names is phase 1's.
10. the issue-rate micro-kernels (B6, ops/peak.py): each built (kernel,
   streams, unroll) against its plain version on the card at full INNER
   and at ops/peak.SHORT = 103 steps (every entry finite there, so a wrong
   shuffle shows) on the TPU tool's inputs from SEED, in two launches (2
   copies in blocks of 128 threads, 3 in one-warp blocks): non-finite
   entries equal in position and sign, finite ones within rtol 1e-4 (mix)
   or 1e-5, copies bitwise equal; then the sweep of every configuration with the card
   filled and in the SMC' kernels' geometry (320 one-warp blocks), with its
   launch count, the best rate of each kernel, the maximum with its plain
   time and bound, and B1-B3 at the measured mix plateau, beside the
   card's name, power limit and SM clock.
`--profile` also prints torch.profiler tables of eager and graphed steps
of each path, with the device busy share.
The last two lines are a JSON summary of the kernels (B1-B6, A1, A2) and
the result line.
It exits non-zero, printing no result, without a CUDA device or when the
package is not beside it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20240601
PATTERNS = {8: "8*1", 16: "14*1+1*2", 32: "32*1", 64: "64*1"}
FIT_SHAPE = (500, 5, 2000)  # (B, S, L) of the fit's likelihood call, where phase 5 times


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


def max_abs(a, b):
    return float((a.double() - b).abs().max())


def normalized(a, b):
    "max |a - b| / max |b|: the gradient gate's measure."
    return max_abs(a, b) / (float(b.abs().max()) + 1e-12)


# (B, S, L, Ms) of the phase-3 checks: a ragged shape (37 particles, so the
# last block of 8 holds 5 real instances and 3 clamped copies; L a multiple
# of 8) for every M, then at M=16 the fit's two shapes: the likelihood
# (L=2000) and the warm-up filter (L=500, whose last period holds 4 live
# sites); and a ragged row longer than two observation tiles (1024 sites)
# whose last period is partial (2501 = 312 * 8 + 5).
CHECK_SHAPES = ((37, 3, 1000, (8, 16, 32, 64)), (500, 5, 2000, (16,)), (500, 5, 500, (16,)),
                (37, 3, 2501, (16,)))


def gate_smc(torch, smc, params, pi, obs, gbar, abar0, where, errs):
    """The forward (B2, with residuals) and adjoint (B3) kernels against
    their plain versions in float64 on the card; B1 (no residuals) must give
    B2's ll and alpha;
    the plain forward itself must agree with the per-site scan oracle
    (hmm.psmc_ll).  Inputs float64; folds the errors into `errs` (as
    check_kernels returns them) and returns the smallest positive
    period-state entry."""
    from phlash_tpu_torch.hmm import psmc_ll
    from phlash_tpu_torch.params import PSMCParams

    f32 = lambda xs: tuple(x.float().contiguous() for x in xs)  # noqa: E731
    p32, pi32, g32, ab32 = f32(params), pi.float().contiguous(), gbar.float(), abar0.float()
    ll_p, a_p, ps_p = smc.forward_structured(params, pi, obs, True)
    a_o, ll_o = psmc_ll(PSMCParams(*(x[:, None, :] for x in params), pi=pi), obs)
    e_o = max(max_rel(ll_p, ll_o), max_rel(a_p, a_o))
    print(f"plain forward {where} vs psmc_ll: max rel err {e_o:.3e}")
    if not e_o <= 1e-10:
        fail(f"the plain forward disagrees with hmm.psmc_ll at {where}")
    g_p, dpi_p = smc.backward_structured(params, obs, ps_p, gbar, abar0)
    names = ("b", "d", "u", "v", "emis0", "emis1", "pi")
    fwd, bwd = errs["forward"], errs["backward"]
    ll_k, a_k, ps_k = smc.forward_cuda(p32, pi32, obs, True)
    ll_1, a_1, _ = smc.forward_cuda(p32, pi32, obs, False)
    g_k, dpi_k = smc.backward_cuda(p32, obs, ps_k, g32, ab32)
    torch.cuda.synchronize()
    e_ll, e_a, e_ps = max_rel(ll_k, ll_p), max_rel(a_k, a_p), max_rel(ps_k, ps_p)
    worst = 0.0
    for name, a, b in zip(names, (*g_k, dpi_k), (*g_p, dpi_p)):
        norm = normalized(a, b)
        worst = max(worst, norm)
        bwd["abs"] = max(bwd["abs"], max_abs(a, b))
        if not norm <= 2e-5:
            fail(f"adjoint kernel disagrees on d{name} at {where}: normalized err {norm:.3e}")
    print(f"{where}: max rel err ll {e_ll:.3e} alpha {e_a:.3e} pstates {e_ps:.3e}; "
          f"max normalized err over the 7 gradients {worst:.3e}")
    if not (e_ll <= 1e-5 and e_a <= 1e-4 and e_ps <= 1e-4):
        fail(f"forward kernel disagrees with the plain version at {where}")
    if not (torch.equal(ll_1, ll_k) and torch.equal(a_1, a_k)):
        fail(f"the forward without residuals differs from the one with at {where}")
    fwd["ll"], fwd["state"] = max(fwd["ll"], e_ll), max(fwd["state"], e_a, e_ps)
    fwd["abs"] = max(fwd["abs"], max_abs(ll_k, ll_p), max_abs(a_k, a_p))
    bwd["grad"] = max(bwd["grad"], worst)
    return float(ps_p[ps_p > 0].min())


def check_kernels(torch, smc, dev):
    """Phase 3: each kernel against its plain version (float64 on the card),
    and the plain forward against the per-site scan oracle (hmm.psmc_ll).
    Returns, per kernel, the largest absolute error and the largest errors in
    the form their gates read (relative for the forward's ll and states,
    normalized for the adjoint's gradients)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"forward": {"abs": 0.0, "ll": 0.0, "state": 0.0}, "backward": {"abs": 0.0, "grad": 0.0}}
    for B, S, L, Ms in CHECK_SHAPES:
        for M in Ms:
            where = f"M={M} B={B} S={S} L={L}"
            params, pi, obs = random_instances(torch, M, B, S, L, dev, gen)
            gbar = torch.randn(B, S, generator=gen, device=dev, dtype=torch.float64)
            abar0 = torch.randn(B, S, M, generator=gen, device=dev, dtype=torch.float64)
            gate_smc(torch, smc, params, pi, obs, gbar, abar0, where, errs)
    return errs


def check_fit_inputs(torch, smc, dev, fit_inputs: dict, errs: dict):
    """Phase 3, continued after the timed steps: B1/B2/B3 on the smc fit's
    own inputs (`fit_inputs`, label -> (params, pi, obs) in float32), where
    the states reach toward float32's smallest normal numbers."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for label, (params, pi, obs) in fit_inputs.items():
        B, S, M = pi.shape
        gbar = torch.randn(B, S, generator=gen, device=dev, dtype=torch.float64)
        abar0 = torch.randn(B, S, M, generator=gen, device=dev, dtype=torch.float64)
        where = f"smc fit inputs, {label}, M={M} B={B} S={S} L={obs.shape[1]}"
        tiny = gate_smc(torch, smc, tuple(x.double() for x in params), pi.double(), obs, gbar,
                        abar0, where, errs)
        print(f"{where}: smallest period-state entry {tiny:.3e}")


# (B, S, L) of the phase-3b checks: a ragged last block (37 particles: 5 real
# instances and 3 clamped copies) with a padded tail, the same over three
# observation tiles with L not a multiple of the period (2501 = 312 * 8 + 5),
# and the fit shape.
PACKED_SHAPES = ((37, 3, 1000), (37, 3, 2501), (500, 5, 2000))


def gate_packed(torch, packed, params, pi, obs, gbar, where, errs):
    """The packed forward (B4, with and without checkpoints) and adjoint (B5)
    kernels against their plain versions in float64 on the card, and the
    plain forward against hmm.psmc_ll.  Inputs float64; folds the errors into
    `errs` (as check_packed_kernels returns them) and returns the smallest
    positive checkpoint entry."""
    from phlash_tpu_torch.hmm import psmc_ll
    from phlash_tpu_torch.ops.packing import dense_transition
    from phlash_tpu_torch.params import PSMCParams

    e0, e1 = params[4:]
    A = dense_transition(PSMCParams(*params, pi=pi))
    k_in = tuple(x.float().contiguous() for x in (A, e0, e1, pi))
    ll_p, ck_p = packed.forward_packed(A, e0, e1, pi, obs)
    _, ll_o = psmc_ll(PSMCParams(*(x[:, None, :] for x in params), pi=pi), obs)
    e_o = max_rel(ll_p, ll_o)
    print(f"plain packed forward {where} vs psmc_ll: max rel err {e_o:.3e}")
    if not e_o <= 1e-10:
        fail(f"the plain packed forward disagrees with hmm.psmc_ll at {where}")
    g_p = packed.backward_packed(A, e0, e1, obs, ck_p, gbar)
    ll_k, ck_k = packed.forward_packed_cuda(*k_in, obs)
    ll_k0, no_ck = packed.forward_packed_cuda(*k_in, obs, with_ckpt=False)
    g_k = packed.backward_packed_cuda(*k_in[:3], obs, ck_k, gbar.float())
    torch.cuda.synchronize()
    e_ll, e_ck = max_rel(ll_k, ll_p), max_rel(ck_k, ck_p)
    if not (e_ll <= 1e-5 and e_ck <= 1e-4):
        fail(f"packed forward kernel disagrees with the plain version at {where}: "
             f"ll {e_ll:.3e} ckpt {e_ck:.3e}")
    if no_ck is not None or not torch.equal(ll_k0, ll_k):
        fail(f"the packed forward without checkpoints differs at {where}")
    worst = 0.0
    for name, a, b in zip(("A", "emis0", "emis1", "pi"), g_k, g_p):
        norm = normalized(a, b)
        worst = max(worst, norm)
        if not norm <= 2e-5:
            fail(f"packed adjoint kernel disagrees on d{name} at {where}: "
                 f"normalized err {norm:.3e}")
    print(f"packed {where}: max rel err ll {e_ll:.3e} ckpt {e_ck:.3e}; "
          f"max normalized err over the 4 gradients {worst:.3e}")
    fwd, bwd = errs["forward"], errs["backward"]
    fwd["ll"], fwd["ckpt"] = max(fwd["ll"], e_ll), max(fwd["ckpt"], e_ck)
    fwd["abs"] = max(fwd["abs"], max_abs(ll_k, ll_p), max_abs(ck_k, ck_p))
    bwd["grad"] = max(bwd["grad"], worst)
    bwd["abs"] = max(bwd["abs"], *(max_abs(a, b) for a, b in zip(g_k, g_p)))
    return float(ck_p[ck_p > 0].min())


def check_packed_kernels(torch, packed, dev):
    """Phase 3b: gate_packed at PACKED_SHAPES on random inputs.  Returns,
    per kernel, the largest absolute error and the largest errors in the
    form their gates read (relative for ll and checkpoints, normalized for
    the gradients)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    errs = {"forward": {"abs": 0.0, "ll": 0.0, "ckpt": 0.0}, "backward": {"abs": 0.0, "grad": 0.0}}
    for B, S, L in PACKED_SHAPES:
        params, pi, obs = random_instances(torch, 16, B, S, L, dev, gen)
        gbar = torch.randn(B, S, generator=gen, device=dev, dtype=torch.float64)
        gate_packed(torch, packed, params, pi, obs, gbar, f"B={B} S={S} L={L}", errs)
    return errs


def check_packed_fit_inputs(torch, packed, dev, fit_inputs: dict, errs: dict):
    """Phase 3b, continued after the timed steps: B4/B5 on the packed fit's
    own inputs (`fit_inputs`, label -> (params, pi, obs) in float32), where
    alpha reaches toward float32's smallest normal numbers."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for label, (params, pi, obs) in fit_inputs.items():
        B, S, _ = pi.shape
        gbar = torch.randn(B, S, generator=gen, device=dev, dtype=torch.float64)
        where = f"packed fit inputs, {label}, B={B} S={S} L={obs.shape[1]}"
        tiny = gate_packed(torch, packed, tuple(x.double() for x in params), pi.double(), obs,
                           gbar, where, errs)
        print(f"{where}: smallest checkpoint entry {tiny:.3e}")


def check_scan(torch, dev) -> dict:
    """Phase 5c: the scan backend (plain PyTorch, float32, as a fit runs it)
    against the smc backend through the hand kernels (B2, B3) on one
    float32 case with a missing block and a padded tail, B=8, S=2, L=500:
    lls and the gradients of a weighted sum of them.  Launches here are
    comparisons, not the fit path's: the caller resets the counters after."""
    from phlash_tpu_torch.hmm import ScanKernel
    from phlash_tpu_torch.ops.kernel_smc import SMCKernel
    from phlash_tpu_torch.params import PSMCParams

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    B, S, L, M = 8, 2, 500, 16
    params, pi, obs = random_instances(torch, M, B, S, L, dev, gen)
    W = torch.randn(B, S, generator=gen, device=dev)
    out = {}
    for name, kern in (("scan", ScanKernel(M, obs, device=dev)),
                       ("smc", SMCKernel(M, obs, device=dev))):
        leaves = [x.float().clone().requires_grad_(True) for x in (*params, pi)]
        ll = kern.loglik_batched(PSMCParams(*leaves), torch.arange(S, device=dev))
        out[name] = ll.detach(), torch.autograd.grad((ll * W).sum(), leaves)
    torch.cuda.synchronize()
    e_ll = max_rel(out["scan"][0], out["smc"][0].double())
    e_g = max(normalized(a, b.double()) for a, b in zip(out["scan"][1], out["smc"][1]))
    print(f"scan vs smc kernels at B={B} S={S} L={L} M={M} (float32): max rel err ll "
          f"{e_ll:.3e}, max normalized err over the 7 gradients {e_g:.3e}")
    if not (e_ll <= 1e-4 and e_g <= 2e-5):
        fail("the scan backend disagrees with the smc kernels")
    return {"ll": e_ll, "grad": e_g}


# phase 3c: the assembly kernels (A1, A2).  (P, patterns, AFS sizes n - 1)
# of the checks: a ragged P (37: the last block of 4 warps, a particle each,
# partly idle) at every M of PATTERNS, with a large AFS (40: more pair
# counts than a warp has lanes), and the fit's P = 500 at M = 16 with the
# fit's own AFS size as well (1: one diploid, its one-row transform) and the
# bench's (9); each at float64 and float32.
ASSEMBLY_SHAPES = ((37, (8, 16, 32, 64), (0, 8, 15, 40)), (500, (16,), (0, 1, 8, 9, 15)))
AFS_TRANSFORMED = (1, 8, 9, 40)  # n - 1 through the fit's default_afs_transform; 15 without
N_EDGE = 6  # assembly_cloud's edge particles, first
EDGE_GRAD = 1e-4  # the edge particles' float32 gradient, normalized: the leaves' relative limit
EPS32 = 2.0 ** -23  # float32's machine epsilon
# The draw-independent float32 gradient gate, beside the 2x rule.  What it
# gates: for each particle set (edge, rest) and gradient coordinate, A2's
# largest difference from the plain float32 gradient (same inputs, same
# device) over that gradient's one-ulp spread there (ulp_spread; at least 4
# ulps of max|plain float32| there), at most ULP_GATE (ulp_ratio).  The two
# versions differ by rounding order, and the spread is what one ulp of input
# moves the gradient by.  Readings of this measure on sound kernels: at most
# 11.70 on an H100 (700 W) over phase 3c's draw, 3.71 on the edges draw;
# 2.88 for A2's device code compiled for the host against the plain version
# on the CPU (tests/test_torch_assembly.py prints it).  What it resolves:
# ulp_resolution, the least change of one coordinate (over its max) that
# reads above ULP_GATE, printed for each case.  A2 against float64 is
# printed, not gated: there both versions also carry float32's rounding of
# the inputs and constants, which a one-ulp move of one coordinate does not
# bound (both read 14 spreads at one coordinate of the edges draw's edge
# particles on the H100).  The factor was fixed before the gate's first run
# on a card (4x 3.93, the CPU reading of the plain float32 version against
# float64, the measure first gated) and has not been changed since.
ULP_GATE = 16.0


def assembly_cloud(torch, pattern: str, P: int, gen, dtype):
    """(init, x (P, D)): coordinates around the default model, the first six
    where the assembly's branches and clamps switch (as
    tests/test_torch_assembly.py's edge particles): a first sub-interval
    short enough for _expQ2's tiny branch, sub-intervals under 1e-8 (the
    degenerate override), c_tr exactly 0 (softplus at 0), c_tr = 5 over a
    long grid (expm1inv's x > 10, the p_surv and 1e-20 clamps), rho above c
    (the w > 0 swap), and a wide spread of rates."""
    import math

    from phlash_tpu_torch.params import MCMCParams
    from phlash_tpu_torch.utils import Pattern

    K = len(Pattern(pattern))
    init = MCMCParams.from_linear(pattern, t1=1e-4, tM=15.0, c=[1.0] * K, theta=1e-2, rho=1e-2,
                                  alpha=0.3, beta=0.01, device=gen.device)
    x0 = init.flatten()
    x = x0 + 0.5 * torch.randn(P, x0.shape[0], generator=gen, device=gen.device,
                               dtype=torch.float64)
    x[0, 0] = math.log(2e-7)
    x[1, 0] = math.log(1e-9)
    x[2, 2:2 + K] = 0.0
    x[3, 1], x[3, 2:2 + K] = math.log(60.0), 5.0
    x[4, 2:2 + K], x[4, -1] = -5.0, 6.0
    x[5, 2:2 + K] = torch.linspace(-6.0, 5.0, K, dtype=torch.float64, device=gen.device)
    return init.to(dtype=dtype), x.to(dtype).contiguous()


def assembly_afs(torch, n_minus_1: int, gen, dtype):
    """(afs, afs_transform) on the card in `dtype`, with a zero count where
    n - 1 > 1, the transform the fit's default where n - 1 is in
    AFS_TRANSFORMED; (None, None) for 0."""
    import numpy as np

    from phlash_tpu_torch.afs import default_afs_transform

    if n_minus_1 == 0:
        return None, None
    afs = torch.randint(1, 60, (n_minus_1,), generator=gen, device=gen.device).to(dtype)
    if n_minus_1 > 1:
        afs[1] = 0.0
    T = None
    if n_minus_1 in AFS_TRANSFORMED:
        T = torch.as_tensor(default_afs_transform(afs.cpu().numpy().astype(np.float64)),
                            dtype=dtype, device=gen.device).contiguous()
    return afs, T


def leaf_errors(torch, a, b, f32: bool) -> list:
    """Per leaf (PSMC_FIELDS order) the gate's measure of a against b: pi
    against max pi (its first entry is 1 minus a sum and cancels); float64
    every other leaf entrywise relative; float32 relative above 1e-12
    (tests/test_torch_params.py's measure)."""
    from phlash_tpu_torch.params import PSMC_FIELDS

    out = []
    for f, name in enumerate(PSMC_FIELDS):
        x, y = a[:, f].double(), b[:, f].double()
        if name == "pi":
            out.append(float((x - y).abs().max()) / (1.0 if f32 else float(y.abs().max())))
            continue
        m = y.abs() > (1e-12 if f32 else 0.0)
        out.append(float(((x - y).abs() / y.abs())[m].max()) if bool(m.any()) else 0.0)
    return out


def f32_errors(torch, k, k_g, p, p_g, want, want_g, terms: int) -> dict:
    """The float32 gate's measures of one set of particles: the kernels' (k,
    k_g) and the plain version's (p, p_g) errors against plain float64 (want,
    want_g): per leaf, the prior and (terms 2) the AFS term relative, the
    gradient normalized; the largest of the kernels' values' errors over
    max(2x the plain one's, 4 ulps), and the gradient's; and whether every
    kernel output is finite."""
    k_l, p_l = (leaf_errors(torch, o[0], want[0], f32=True) for o in (k, p))
    k_t = [max_rel(a, b) for a, b in zip(k[1:1 + terms], want[1:1 + terms])]
    p_t = [max_rel(a, b) for a, b in zip(p[1:1 + terms], want[1:1 + terms])]
    e_kg, e_pg = normalized(k_g, want_g), normalized(p_g, want_g)
    over = lambda kk, pp: kk / max(2 * pp, 4 * EPS32)  # noqa: E731
    finite = all(bool(torch.isfinite(t).all()) for t in (*k, k_g))
    return dict(leaves=k_l, plain_leaves=p_l, terms=k_t, plain_terms=p_t, grad=e_kg,
                plain_grad=e_pg, ratio_values=max(map(over, [*k_l, *k_t], [*p_l, *p_t])),
                ratio_grad=over(e_kg, e_pg), finite=finite,
                max_abs_fwd=max_abs(k[0], want[0]), max_abs_grad=max_abs(k_g, want_g))


def ulp_spread(torch, init, x, afs, T, g):
    """(plain, spread): the plain float32 gradient (P, D) of A2's function at
    x (P, D) with cotangents g, and its one-ulp spread: for each particle
    and gradient coordinate, the largest change of that gradient when one
    coordinate of x moves by one ulp, up or down, over the D coordinates and
    both directions.  One call of the plain version on the P particles
    stacked 2 D + 1 times (each particle's gradient is its own)."""
    import math

    from phlash_tpu_torch.ops import assembly

    P, D = x.shape
    eye = torch.eye(D, dtype=torch.bool, device=x.device)
    stack = [x]
    for to in (math.inf, -math.inf):
        moved = torch.nextafter(x, torch.full_like(x, to))
        stack.append(torch.where(eye[:, None, :], moved[None], x[None]).reshape(D * P, D))
    grad = assembly.assemble_vjp_plain(
        init, torch.cat(stack).contiguous(), afs, T,
        *(t.repeat(2 * D + 1, *([1] * (t.dim() - 1))) for t in g))
    plain = grad[:P]
    return plain, (grad[P:].view(2 * D, P, D) - plain).abs().amax(0)


def ulp_ratio(torch, got, ref, spread) -> float:
    """The one-ulp gate's reading on a set of particles' gradients (P, D):
    the largest, over gradient coordinates, of max|got - ref| there over the
    one-ulp spread there (or 4 ulps of max|ref| there, if larger)."""
    ref = ref.double()
    err = (got.double() - ref).abs().amax(0)
    floor = 4 * EPS32 * ref.abs().amax(0)
    return float((err / torch.maximum(spread.double().amax(0), floor)).max())


def ulp_resolution(torch, ref, spread) -> tuple[float, float]:
    """(median, worst) over the gradient coordinates of a set of particles
    (P, D) of the least change of that coordinate, over max|ref| there, that
    the one-ulp gate fails: ULP_GATE times ulp_ratio's denominator there over
    max|ref| there (coordinates where ref is all 0 left out)."""
    ref = ref.double()
    scale = ref.abs().amax(0)
    res = ULP_GATE * torch.maximum(spread.double().amax(0), 4 * EPS32 * scale) / scale
    res = res[scale > 0]
    return float(res.median()), float(res.max())


def edges_cases(torch, dev):
    """tools/torch_assembly_edges.py's draw: 500 particles at M = 16 from
    SEED + 30, at n - 1 = 0, 1 and 8; yields (n - 1, init, x, afs, T, g),
    float64, in that order."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    P, M = 500, 16
    init, x = assembly_cloud(torch, PATTERNS[M], P, gen, torch.float64)
    for nm1 in (0, 1, 8):
        afs, T = assembly_afs(torch, nm1, gen, torch.float64)
        g = [torch.randn(s, generator=gen, device=dev, dtype=torch.float64)
             for s in ((P, 7, M), (P,), (P,))]
        yield nm1, init, x, afs, T, g


def check_assembly(torch, dev) -> dict:
    """Phase 3c: A1 and A2 (ops/assembly.py) against their plain versions on
    the card at ASSEMBLY_SHAPES.  float64, every particle: leaves, prior and
    AFS term rtol 1e-10 (pi against max pi), the gradient of a random dot
    with the outputs within 1e-8 of max|plain|.  float32, the N_EDGE edge
    particles and the rest each on their own: every output finite, each
    value against the plain float64 version no worse than twice the plain
    float32 version's own error (or 4 float32 ulps), the leaves within 1e-4
    relative (above 1e-12) and pi within 1e-6 absolute; the gradient on the
    rest under the same 2x rule, on the edge particles within EDGE_GRAD of
    max|plain float64|.  There (a sub-interval under 1e-8 gives gradients
    of ~1e7) the plain float32 gradient moves by 2.6e-7 to 5.9e-7 of
    max|grad| when its inputs move by one ulp (tools/torch_assembly_edges.py),
    so a ratio to its own error compares two draws of rounding noise.
    Beside these rules, and on edges_cases' draw too, the draw-independent
    gate: each particle set's float32 gradient within ULP_GATE one-ulp
    spreads of the plain float32 gradient (ulp_ratio; the same reading
    against float64 is printed).  Every case is checked and printed before a
    failure ends the phase.  Returns the largest errors."""
    from phlash_tpu_torch.ops import assembly
    from phlash_tpu_torch.params import PSMC_FIELDS

    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    errs = {"f64_values": 0.0, "f64_grad": 0.0, "f32_leaves": 0.0, "f32_grad": 0.0,
            "f32_over_plain": 0.0, "f32_edge_grad": 0.0, "max_abs_fwd": 0.0,
            "max_abs_grad": 0.0, "f32_ulp_ratio": 0.0, "f32_ulp_ratio_edges_draw": 0.0,
            "f32_ulp_ratio_f64": 0.0}
    failures = []
    for P, Ms, afs_sizes in ASSEMBLY_SHAPES:
        for M in Ms:
            pattern = PATTERNS[M]
            init, x = assembly_cloud(torch, pattern, P, gen, torch.float64)
            for nm1 in afs_sizes:
                where = f"M={M} P={P} n-1={nm1}"
                afs, T = assembly_afs(torch, nm1, gen, torch.float64)
                g = [torch.randn(s, generator=gen, device=dev, dtype=torch.float64)
                     for s in ((P, 7, M), (P,), (P,))]
                want = assembly.assemble_plain(init, x, afs, T)
                want_g = assembly.assemble_vjp_plain(init, x, afs, T, *g)
                got = assembly.forward_cuda(init, x, afs, T)
                got_g = assembly.backward_cuda(init, x, afs, T, *g)
                torch.cuda.synchronize()
                e_leaves = leaf_errors(torch, got[0], want[0], f32=False)
                e_terms = [max_rel(a, b) for a, b in zip(got[1:], want[1:])]
                e_g = normalized(got_g, want_g)
                errs["f64_values"] = max(errs["f64_values"], *e_leaves, *e_terms)
                errs["f64_grad"] = max(errs["f64_grad"], e_g)
                if not (max(*e_leaves, *e_terms) <= 1e-10 and e_g <= 1e-8):
                    failures.append(f"{where}, float64: leaves "
                                    f"{dict(zip(PSMC_FIELDS, e_leaves))}, prior / AFS term "
                                    f"{e_terms}, gradient {e_g:.3e}")

                # float32: the kernels and the plain version, each against float64
                i32, x32 = init.to(dtype=torch.float32), x.float().contiguous()
                a32 = None if afs is None else afs.float()
                T32 = None if T is None else T.float().contiguous()
                g32 = [t.float().contiguous() for t in g]
                k = assembly.forward_cuda(i32, x32, a32, T32)
                k_g = assembly.backward_cuda(i32, x32, a32, T32, *g32)
                p = assembly.assemble_plain(i32, x32, a32, T32)
                p_g = assembly.assemble_vjp_plain(i32, x32, a32, T32, *g32)
                p_s, spread = ulp_spread(torch, i32, x32, a32, T32, g32)
                torch.cuda.synchronize()
                parts = {}
                for part, sl in (("edge", slice(0, N_EDGE)), ("rest", slice(N_EDGE, None))):
                    e = parts[part] = f32_errors(
                        torch, [o[sl] for o in k], k_g[sl], [o[sl] for o in p], p_g[sl],
                        [o[sl] for o in want], want_g[sl], 2 if nm1 else 1)
                    limits = [1e-4] * 6 + [1e-6]
                    grad_ok = (e["grad"] <= EDGE_GRAD if part == "edge"
                               else e["ratio_grad"] <= 1.0)
                    e["ulp"] = ulp_ratio(torch, k_g[sl], p_s[sl], spread[sl])
                    e["ulp_f64"] = ulp_ratio(torch, k_g[sl], want_g[sl], spread[sl])
                    e["ulp_f64_plain"] = ulp_ratio(torch, p_s[sl], want_g[sl], spread[sl])
                    e["resolution"] = ulp_resolution(torch, p_s[sl], spread[sl])
                    if (not e["finite"] or e["ratio_values"] > 1.0 or not grad_ok
                            or e["ulp"] > ULP_GATE
                            or any(v > lim for v, lim in zip(e["leaves"], limits))):
                        failures.append(
                            f"{where}, float32, {part} particles, against float64: finite "
                            f"{e['finite']}, leaves {e['leaves']} (plain {e['plain_leaves']}), "
                            f"prior / AFS term {e['terms']} (plain {e['plain_terms']}), "
                            f"gradient {e['grad']:.3e} (plain {e['plain_grad']:.3e}), "
                            f"{e['ulp']:.2f} one-ulp spreads from the plain float32 gradient "
                            f"(limit {ULP_GATE:g})")
                    errs["f32_ulp_ratio"] = max(errs["f32_ulp_ratio"], e["ulp"])
                    errs["f32_ulp_ratio_f64"] = max(errs["f32_ulp_ratio_f64"], e["ulp_f64"])
                    errs["f32_leaves"] = max(errs["f32_leaves"], *e["leaves"])
                    errs["max_abs_fwd"] = max(errs["max_abs_fwd"], e["max_abs_fwd"])
                    errs["max_abs_grad"] = max(errs["max_abs_grad"], e["max_abs_grad"])
                    key = "f32_edge_grad" if part == "edge" else "f32_grad"
                    errs[key] = max(errs[key], e["grad"])
                    errs["f32_over_plain"] = max(errs["f32_over_plain"], e["ratio_values"],
                                                 0.0 if part == "edge" else e["ratio_grad"])
                r, ed = parts["rest"], parts["edge"]
                print(f"assembly {where}: float64 max rel err {max(*e_leaves, *e_terms):.3e}, "
                      f"gradient {e_g:.3e}; float32 leaves {max(r['leaves']):.3e} (plain "
                      f"{max(r['plain_leaves']):.3e}), gradient {r['grad']:.3e} (plain "
                      f"{r['plain_grad']:.3e}), {max(r['ratio_values'], r['ratio_grad']):.2f} "
                      f"of the gate; edge particles' float32 values "
                      f"{ed['ratio_values']:.2f} of the gate, gradient {ed['grad']:.3e} "
                      f"(plain {ed['plain_grad']:.3e}; limit {EDGE_GRAD:g}); gradient "
                      f"{r['ulp']:.2f} / {ed['ulp']:.2f} one-ulp spreads from the plain float32 "
                      f"one (rest / edge particles; limit {ULP_GATE:g}); against float64, not "
                      f"gated, A2 {r['ulp_f64']:.2f} / {ed['ulp_f64']:.2f}, plain float32 "
                      f"{r['ulp_f64_plain']:.2f} / {ed['ulp_f64_plain']:.2f}; the gate fails a "
                      f"change of one coordinate by {r['resolution'][0]:.2e} / "
                      f"{ed['resolution'][0]:.2e} of its max (median over coordinates; worst "
                      f"{r['resolution'][1]:.2e} / {ed['resolution'][1]:.2e})")
    # the one-ulp gate on tools/torch_assembly_edges.py's draw, where the 2x
    # rule, which gates only the draw above, read 4.5 (printed, not gated)
    for nm1, init, x, afs, T, g in edges_cases(torch, dev):
        where = f"edges draw, M=16 P=500 n-1={nm1}"
        want_g = assembly.assemble_vjp_plain(init, x, afs, T, *g)
        i32, x32 = init.to(dtype=torch.float32), x.float().contiguous()
        a32 = None if afs is None else afs.float()
        T32 = None if T is None else T.float().contiguous()
        g32 = [t.float().contiguous() for t in g]
        k_g = assembly.backward_cuda(i32, x32, a32, T32, *g32)
        p_g = assembly.assemble_vjp_plain(i32, x32, a32, T32, *g32)
        p_s, spread = ulp_spread(torch, i32, x32, a32, T32, g32)
        torch.cuda.synchronize()
        parts = (("edge", slice(0, N_EDGE)), ("rest", slice(N_EDGE, None)))
        ulp = {part: ulp_ratio(torch, k_g[sl], p_s[sl], spread[sl]) for part, sl in parts}
        f64 = {part: ulp_ratio(torch, k_g[sl], want_g[sl], spread[sl]) for part, sl in parts}
        res = {part: ulp_resolution(torch, p_s[sl], spread[sl]) for part, sl in parts}
        rest = slice(N_EDGE, None)
        two_x = normalized(k_g[rest], want_g[rest]) / max(
            2 * normalized(p_g[rest], want_g[rest]), 4 * EPS32)
        errs["f32_ulp_ratio_edges_draw"] = max(errs["f32_ulp_ratio_edges_draw"], *ulp.values())
        errs["f32_ulp_ratio_f64"] = max(errs["f32_ulp_ratio_f64"], *f64.values())
        print(f"assembly {where}: float32 gradient {ulp['rest']:.2f} / {ulp['edge']:.2f} "
              f"one-ulp spreads from the plain float32 one (rest / edge particles; limit "
              f"{ULP_GATE:g}); against float64, not gated, {f64['rest']:.2f} / "
              f"{f64['edge']:.2f}; the 2x rule, not gated on this draw, reads {two_x:.2f} of "
              f"its limit; the gate fails a change of one coordinate by {res['rest'][0]:.2e} / "
              f"{res['edge'][0]:.2e} of its max (median; worst {res['rest'][1]:.2e} / "
              f"{res['edge'][1]:.2e})")
        if max(ulp.values()) > ULP_GATE:
            failures.append(f"{where}: float32 gradient at {ulp} one-ulp spreads (limit "
                            f"{ULP_GATE:g})")
    if failures:
        fail("assembly kernels disagree with their plain version at " + "; ".join(failures))
    return errs


# (kernel_backend, overlap) of the phase-6 fits; the committed phlash_tpu.fit
# posterior of each overlap is tests/data/torch_posterior_overlap<overlap>.npz
REPRO_PATHS = (("smc", 500), ("packed", 0))


class Records(logging.Handler):
    """Collects a logger's records at `level` and up; at each 'fit finished'
    record, the StepMeter's setup seconds and its rate at that moment."""

    def __init__(self, level=logging.DEBUG):
        super().__init__(level)
        self.records, self.meters = [], []

    def emit(self, record):
        self.records.append(record)
        if hasattr(record, "step_meter"):
            m = record.step_meter
            self.meters.append(dict(setup_seconds=m.setup_seconds, steps_per_sec=m.steps_per_sec))


def ensemble_digest(models) -> str:
    "A hash of a posterior ensemble's values (t, c, rho of every model, in order)."
    h = hashlib.sha256()
    for m in models:
        for x in (m.eta.t, m.eta.c):
            h.update(x.detach().cpu().numpy().tobytes())
        h.update(struct.pack("<d", m.rho))
    return h.hexdigest()[:16]


def repro_phase(torch, ops: dict) -> list[dict]:
    """Phase 6: regenerate the fixture's dataset, fit it on the card on each
    path of REPRO_PATHS once per fixture key (as the seed), and hold each
    pooled ensemble against phlash_tpu.fit's (repro.compare).  Fails on a
    wrong launch count, a failed gate, or a gate that passes the largest
    planted bias."""
    import phlash_tpu_torch
    from phlash_tpu_torch import repro, results, sim

    data = ROOT / "tests" / "data"
    meta = json.loads((data / "torch_posterior_fixture.json").read_text())
    truth = sim.bottleneck_demography(theta=1e-2)
    t0 = time.perf_counter()
    contigs = [sim.simulate_smc_continuous(truth, L=meta["L"], seed=s, n_samples=1)
               for s in meta["seeds"]]
    print(f"repro: simulated {len(contigs)} contigs of {meta['L']} windows in "
          f"{time.perf_counter() - t0:.2f} s (phlash_tpu_torch.sim); het share "
          f"{[round(float((c.het_matrix == 1).mean()), 6) for c in contigs]}")
    afs_on = all(c.afs is not None for c in contigs)
    print(f"repro: composite compared: prior + chunk HMM + AFS term ({'on' if afs_on else 'off'}, "
          f"both packages)")
    niter, P, seeds = meta["shared"]["niter"], meta["shared"]["num_particles"], meta["keys"]
    if niter % SPC:
        fail(f"the fixture's niter {niter} is not a multiple of {SPC}")
    # per fit: niter iterations by replay of one graph plus its eager warm-up
    # iteration; no held-out data, so no ELPD
    log = logging.getLogger("phlash_tpu_torch.mcmc")
    meters, level = Records(logging.INFO), log.level
    log.addHandler(meters)
    log.setLevel(logging.INFO)
    out = []
    for backend, overlap in REPRO_PATHS:
        want = expected_counts(backend, niter, elpd=False)
        pooled, walls, captures = [], [], []
        for seed in seeds:
            for mod in ops.values():
                mod.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            post = phlash_tpu_torch.fit(contigs, device="cuda", seed=seed, kernel_backend=backend,
                                        window_size=meta["window_size"], overlap=overlap,
                                        chunk_size=meta["chunk_size"], progress=False,
                                        **meta["shared"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            captures.append(meters.meters.pop()["setup_seconds"])
            check_counts({name: mod.counts() for name, mod in ops.items()}, want,
                         f"the {backend} repro fit (seed {seed})")
            if len(post) != P or not all(torch.isfinite(m.eta.c).all() and (m.eta.c > 0).all()
                                         for m in post):
                fail(f"the {backend} repro fit (seed {seed}) did not return {P} finite models")
            pooled += post
        ref = results.load_posterior(str(data / f"torch_posterior_overlap{overlap}.npz"))
        res = repro.compare(pooled, ref, truth)
        # each single fit against phlash_tpu's ensemble: the seed's spread (not gated)
        single = [repro.compare(pooled[i: i + P], ref, truth)["tv_cross"]
                  for i in range(0, len(pooled), P)]
        # what the gate catches: the port's ensemble with planted biases
        planted = repro.planted(pooled, ref, truth)
        line = dict(phase="repro", kernel_backend=backend, overlap=overlap, seeds=seeds,
                    particles=len(pooled), ref_particles=len(ref), afs_term=afs_on,
                    ensemble_sha256=ensemble_digest(pooled), launches_per_fit=want,
                    fit_wall_s=walls,
                    fit_wall_s_without_capture=[w - c for w, c in zip(walls, captures)],
                    tv_cross_single_fits=single, planted=planted, **res)
        print(f"repro {backend}: {len(seeds)} fits of {niter} iterations at {P} particles, "
              f"{sum(walls):.2f} s in all ({min(walls):.3f}-{max(walls):.3f} s a fit, "
              f"{min(w - c for w, c in zip(walls, captures)):.3f}-"
              f"{max(w - c for w, c in zip(walls, captures)):.3f} s without graph capture)")
        print(json.dumps(line))
        if not res["ok"]:
            fail(f"the {backend} posterior does not reproduce phlash_tpu.fit's: {res}")
        if planted[str(repro.PLANT_FACTORS[-1])]["ok"]:
            fail(f"the {backend} gate passes the largest planted bias: {planted}")
        out.append(line)
    log.removeHandler(meters)
    log.setLevel(level)
    return out


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


# (kernel_backend, overlap) of the two fit paths that phase 4 drives
PATHS = (("smc", 500), ("packed", 0))
NITER = 30  # SVGD iterations of the phase-4 fits
SPC = 10  # steps_per_call, the CUDA default: one graph replay per 10 iterations
SLICE = dict(num_particles=500, minibatch_size=5, chunk_size=2000)


def expected_counts(backend: str, niter: int = NITER, elpd: bool = True) -> dict:
    """Launches of a fit (phases 4, 4b, 7, 8a with held-out data; phase 6
    without), by ops module: niter (a multiple of SPC) iterations by graph
    replay, an ELPD in each of the niter / SPC calls (its cadence, 10
    iterations, is one call), and the eager warm-up iteration (and ELPD)
    before the one capture.  An smc iteration runs the warm-up filter and
    the likelihood, each B2 + B3; its ELPD two B1.  A packed iteration runs
    B4 + B5, its ELPD one B4.  Every iteration runs A1 + A2 (the assembly and
    its gradient), every ELPD one A1; the other backend's module launches
    nothing."""
    steps, elpds = niter + 1, (niter // SPC + 1 if elpd else 0)
    none = dict(forward_cuda=0, backward_cuda=0, forward_plain=0, backward_plain=0)
    out = {"smc": dict(none, forward_cuda_residuals=0), "packed": dict(none),
           "assembly": dict(none, forward_cuda=steps + elpds, backward_cuda=steps)}
    if backend == "smc":
        out["smc"].update(forward_cuda=2 * steps + 2 * elpds, forward_cuda_residuals=2 * steps,
                          backward_cuda=2 * steps)
    else:
        out["packed"].update(forward_cuda=steps + elpds, backward_cuda=steps)
    return out


def check_counts(counts: dict, want: dict, what: str) -> None:
    "Fail unless every ops module launched exactly what `want` (expected_counts) says."
    if counts != want:
        fail(f"{what} launched {counts}; expected {want}")


def run_slice(torch, ops, dev, path: Path, backend: str, overlap: int):
    """Phases 4 / 4b: the fit path through the public entry point with
    `backend`; ops maps backend -> its ops module (launch counters).  Returns
    every module's counts and the models."""
    import phlash_tpu_torch

    for mod in ops.values():
        mod.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    models = phlash_tpu_torch.psmc([str(path)], device="cuda", kernel_backend=backend,
                                   niter=NITER, overlap=overlap, **SLICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: mod.counts() for name, mod in ops.items()}
    print(f"slice {backend}: psmc(niter={NITER}, overlap={overlap}) took {wall:.2f} s "
          f"(graph capture included); launch counts {counts}")
    check_counts(counts, expected_counts(backend), f"the {backend} fit")
    if len(models) != 500:
        fail(f"expected 500 models, got {len(models)}")
    for m in models:
        if not (torch.isfinite(m.eta.t).all() and torch.isfinite(m.eta.c).all()
                and (m.eta.c > 0).all() and m.rho == m.rho):
            fail("a returned model is not finite")
    Ne = torch.stack([0.5 / m.eta.c for m in models])
    print(f"slice {backend}: 500 finite models; median Ne(t) over particles at M epochs: "
          f"{[f'{x:.4g}' for x in Ne.median(0).values.tolist()]}")
    return counts, models


def build_program(torch, dev, path: Path, backend: str, overlap: int, num_particles=500,
                  minibatch_size=5, chunk_size=2000, niter=NITER, mesh=None):
    """One path's training program on the slice's data, the first contig held
    out, its chunks, and the held-out ELPD on that contig (sharded over
    `mesh` if given)."""
    from phlash_tpu_torch.data import RawContig, init_mcmc_data
    from phlash_tpu_torch.mcmc import held_out_elpd
    from phlash_tpu_torch.training import build_training

    held, *contigs = RawContig.from_psmcfa_iter(str(path), 100)
    afs, chunks = init_mcmc_data(contigs, 100, overlap, chunk_size)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prog = build_training(chunks, afs, window_size=100, overlap=overlap, device=dev,
                          generator=gen, kernel_backend=backend, mesh=mesh,
                          options=dict(num_particles=num_particles,
                                       minibatch_size=minibatch_size, niter=niter))
    elpd = held_out_elpd(prog, held, span=int(chunks.shape[-1]), overlap=overlap,
                         elpd_samples=None, device=dev, kernel_backend=backend)
    return prog, chunks, elpd


def packed_fit_inputs(torch, prog, chunks, dev):
    """B4/B5 inputs as the packed fit makes them from its current particles,
    on the first S = 5 of its chunks (2000 sites), float32: the six
    parameter rows, pi and the rows (the kernels take A = dense_transition)."""
    from phlash_tpu_torch.params import PSMCParams

    with torch.no_grad():
        pp = PSMCParams.from_dm(prog.init.unflatten(prog.state.particles).to_dm())
    params = tuple(getattr(pp, k).float().contiguous()
                   for k in ("b", "d", "u", "v", "emis0", "emis1"))
    pi = pp.pi[:, None, :].expand(-1, 5, -1).float().contiguous()
    obs = torch.as_tensor(chunks[:5], dtype=torch.int8, device=dev)
    return params, pi, obs


def smc_fit_inputs(torch, prog, chunks, dev):
    """B1-B3 inputs as the smc fit makes them from its current particles, on
    the first S = 5 of its chunks, float32: the warm-up filter (pi from the
    particles, the 500-site prefixes) and the likelihood (pi the filtered
    state, the 2000 sites after)."""
    from phlash_tpu_torch.ops import smc
    from phlash_tpu_torch.params import PSMCParams

    with torch.no_grad():
        pp = PSMCParams.from_dm(prog.init.unflatten(prog.state.particles).to_dm())
        params = tuple(getattr(pp, k).float().contiguous()
                       for k in ("b", "d", "u", "v", "emis0", "emis1"))
        rows = torch.as_tensor(chunks[:5], dtype=torch.int8, device=dev)
        warm, data = rows[:, :500].contiguous(), rows[:, 500:].contiguous()
        pi0 = pp.pi[:, None, :].expand(-1, 5, -1).float().contiguous()
        _, pi1, _ = smc.forward_cuda(params, pi0, warm, False)
    return {"filter L=500": (params, pi0, warm), "likelihood L=2000": (params, pi1, data)}


def time_eager(torch, prog, gen, n: int = 20):
    """n eager SVGD iterations (base_step) of `prog` after 3 of warm-up, host
    clock: (ms per iteration to the final synchronize, ms per iteration to
    enqueue them)."""
    inds = torch.randint(prog.N, (n + 3, prog.S), generator=gen, device=prog.warmup.device)
    state = prog.state
    for row in inds[:3]:
        state = prog.base_step(state, row)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for row in inds[3:]:
        state = prog.base_step(state, row)
    t_enqueued = time.perf_counter()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prog.state = state
    return (t1 - t0) / n * 1e3, (t_enqueued - t0) / n * 1e3


def time_graphed(torch, prog, gen, calls: int = 4):
    """`calls` graphed calls of prog.steps_per_call iterations (prog.step)
    after 2 of warm-up (the first captures): ms per iteration, to the final
    synchronize and to enqueue."""
    from phlash_tpu_torch.training import clone_state

    k = prog.steps_per_call
    inds = torch.randint(prog.N, (calls + 2, k, prog.S), generator=gen,
                         device=prog.warmup.device)
    state = prog.state
    for rows in inds[:2]:
        state, _ = prog.step(state, rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rows in inds[2:]:
        state, _ = prog.step(state, rows)
    t_enqueued = time.perf_counter()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prog.state = clone_state(state)
    return (t1 - t0) / (calls * k) * 1e3, (t_enqueued - t0) / (calls * k) * 1e3


HAND_KERNELS = ("smc_forward_kernel", "smc_backward_kernel", "packed_forward_kernel",
                "packed_backward_kernel", "assembly_forward_kernel", "assembly_backward_kernel")


def profile_steps(torch, prog, gen, b: str, graphed: bool, tables: bool = True) -> dict:
    """torch.profiler over 20 graphed iterations (2 calls) or 5 eager ones of
    `prog`, per iteration: device time (kernels and copies), kernels on the
    card (the hand kernels apart), the hand kernels' device time, the
    host's kernel and graph launch calls, and the busy share (device time
    over the window's wall time, which the profiler stretches).  Prints
    them, and with `tables` the profiler's tables."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    from phlash_tpu_torch.training import clone_state

    k = prog.steps_per_call if graphed else 1
    n_calls = 2 if graphed else 5
    inds = torch.randint(prog.N, (n_calls, k, prog.S), generator=gen,
                         device=prog.warmup.device)
    state = prog.state
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for rows in inds:
            state = prog.step(state, rows)[0] if graphed else prog.base_step(state, rows[0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prog.state = clone_state(state)
    iters = n_calls * k
    events = p.events()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in on_card if not e.name.startswith(("Memcpy", "Memset"))]
    hand = [e for e in kernels if any(h in e.name for h in HAND_KERNELS)]
    dev_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3
    out = dict(device_ms_per_iter=dev_ms / iters,
               hand_kernel_ms_per_iter=sum(e.time_range.elapsed_us() for e in hand) / 1e3 / iters,
               kernels_per_iter=len(kernels) / iters, hand_kernels_per_iter=len(hand) / iters,
               other_kernels_per_iter=(len(kernels) - len(hand)) / iters,
               host_calls_per_iter={name: sum(e.name == name for e in events) / iters
                                    for name in ("cudaLaunchKernel", "cudaGraphLaunch")},
               busy_share=dev_ms / wall, wall_ms_per_iter_profiled=wall / iters)
    what = "graphed" if graphed else "eager"
    print(f"profile of {iters} {what} SVGD iterations, {b}: device time "
          f"{out['device_ms_per_iter']:.3f} ms an iteration ({out['hand_kernel_ms_per_iter']:.3f} "
          f"in hand kernels), wall {out['wall_ms_per_iter_profiled']:.3f} ms an iteration, "
          f"device busy share {out['busy_share']:.3f}; kernels an iteration "
          f"{out['hand_kernels_per_iter']:g} hand + {out['other_kernels_per_iter']:g} other; "
          f"host calls an iteration {out['host_calls_per_iter']}")
    if tables:
        print(p.key_averages().table(sort_by="cuda_time_total", row_limit=25))
        print(p.key_averages().table(sort_by="self_cpu_time_total", row_limit=12))
    return out


def step_timing(torch, progs: dict, profile: bool) -> dict:
    """Phase 4c: ms per SVGD iteration of each path's program, eager and
    graphed, timed in turns (smc, packed, packed, smc); the mean of the two
    turns per path and mode."""
    overlaps = dict(PATHS)
    gen = torch.Generator(device=next(iter(progs.values())).warmup.device).manual_seed(SEED + 6)
    ms = {(b, mode): [] for b in progs for mode in ("eager", "graphed")}
    for b in ("smc", "packed", "packed", "smc"):
        for mode, timer in (("eager", time_eager), ("graphed", time_graphed)):
            total, enqueued = timer(torch, progs[b], gen)
            ms[(b, mode)].append(total)
            print(f"svgd step {b} {mode}: {total:.3f} ms/iter, enqueued in {enqueued:.3f} "
                  f"ms/iter (500 particles, S=5, chunk 2000 + {overlaps[b]})")
    for b, prog in progs.items():
        for (k, with_elpd), sec in prog.step.setup_seconds.items():
            print(f"graph setup {b} ({k} iterations, ELPD {with_elpd}): warm-up "
                  f"{sec['warmup']:.3f} s, capture and instantiation {sec['capture']:.3f} s")
    if profile:
        for b, prog in progs.items():
            for graphed in (False, True):
                profile_steps(torch, prog, gen, b, graphed)
    return {key: sum(v) / len(v) for key, v in ms.items()}


def graphed_vs_eager(torch, prog, elpd, label: str, seed: int) -> dict:
    """Phase 4d: one graphed call of prog.steps_per_call iterations with the
    ELPD (a fresh Caller: warm-up, capture, replay) against as many eager
    base_steps and the eager ELPD, from one state and one set of index rows.
    Returns the largest relative errors."""
    from phlash_tpu_torch.training import Caller, clone_state

    dev = prog.warmup.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = prog.steps_per_call
    inds = torch.randint(prog.N, (k, prog.S), generator=gen, device=dev)
    elpd_inds = elpd.draw(gen)
    start = clone_state(prog.state)
    caller = Caller(prog.base_step, elpd)
    g_state, g_elpd = caller(clone_state(start), inds, elpd_inds)
    graph = caller.graphs[(k, True)]
    e_state = clone_state(start)
    for row in inds:
        e_state = prog.base_step(e_state, row)
    e_elpd = elpd(e_state.particles, elpd_inds)
    torch.cuda.synchronize()
    if not (torch.equal(graph.inds, inds) and torch.equal(graph.elpd_inds, elpd_inds)):
        fail(f"graphed call {label}: the graph's index buffers differ from the eager indices")
    names = ("particles", "mu", "nu", "nu_max")
    errs = {n: max_rel(a, b) for n, a, b in zip(names, g_state.tensors(), e_state.tensors())}
    errs["elpd"] = max_rel(g_elpd, e_elpd)
    bitwise = all(torch.equal(a, b) for a, b in zip(g_state.tensors(), e_state.tensors()))
    sec = caller.setup_seconds[(k, True)]
    print(f"graphed vs eager {label}: {k} iterations, count {int(g_state.opt_state.count)} / "
          f"{int(e_state.opt_state.count)}; max rel err "
          + ", ".join(f"{n} {v:.3e}" for n, v in errs.items())
          + f"; state bitwise equal: {bitwise}; ELPD {float(g_elpd):.6f} / {float(e_elpd):.6f}; "
          f"warm-up {sec['warmup']:.3f} s, capture and instantiation {sec['capture']:.3f} s")
    if not torch.equal(g_state.opt_state.count, e_state.opt_state.count):
        fail(f"graphed call {label}: the amsgrad count differs")
    if not max(errs.values()) <= 1e-6:
        fail(f"graphed call {label} disagrees with the eager steps: {errs}")
    return errs


def resume_check(torch, path: Path, tmp: str, want_models) -> float:
    """Phase 4e: psmc(niter=20) with a checkpoint every 10 iterations, then
    the same call with niter=30, against phase 4's uninterrupted niter=30
    fit (`want_models`): largest relative error of the returned models."""
    import phlash_tpu_torch

    ck = str(Path(tmp) / "resume.npz")
    kw = dict(device="cuda", kernel_backend="smc", overlap=500, checkpoint_path=ck,
              save_every=10, **SLICE)
    t0 = time.perf_counter()
    phlash_tpu_torch.psmc([str(path)], niter=20, **kw)
    got = phlash_tpu_torch.psmc([str(path)], niter=NITER, **kw)
    wall = time.perf_counter() - t0
    err = max(max(max_rel(g.eta.c, w.eta.c), max_rel(g.eta.t, w.eta.t))
              for g, w in zip(got, want_models))
    same = all(torch.equal(g.eta.c, w.eta.c) for g, w in zip(got, want_models))
    print(f"resume: psmc(niter=20, save_every=10) then psmc(niter={NITER}) against the "
          f"uninterrupted fit: max rel err {err:.3e} over eta.c and eta.t, bitwise equal: "
          f"{same} ({wall:.2f} s)")
    if len(got) != len(want_models) or not err <= 1e-6:
        fail("the resumed fit differs from the uninterrupted one")
    return err


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


def kernel_timing(torch, smc, dev, fit_inputs: dict):
    """Phase 5: each SMC' kernel and its plain version at the fit shape,
    float32, with the kernels' launch geometry; then B2 and B3 on the smc
    fit's own inputs (`fit_inputs`, label -> smc_fit_inputs' dict).  The
    bounds are roofline.py's."""
    from phlash_tpu_torch import roofline

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    (B, S, L), M = FIT_SHAPE, 16
    params, pi, obs = random_instances(torch, M, B, S, L, dev, gen)
    obs[obs == -2] = 0  # the fit's rows carry no padding
    params = tuple(x.float().contiguous() for x in params)
    pi = pi.float().contiguous()
    gbar = torch.randn(B, S, generator=gen, device=dev)
    abar0 = torch.randn(B, S, M, generator=gen, device=dev)
    _, _, ps_p = smc.forward_structured(params, pi, obs, True)
    t = {
        "fwd_plain": time_ms(torch, lambda: smc.forward_structured(params, pi, obs, False), 2),
        "fwd_res_plain": time_ms(torch, lambda: smc.forward_structured(params, pi, obs, True), 2),
        "bwd_plain": time_ms(
            torch, lambda: smc.backward_structured(params, obs, ps_p, gbar, abar0), 2),
        "fwd_grad_plain": time_ms(torch, lambda: smc.backward_structured(
            params, obs, smc.forward_structured(params, pi, obs, True)[2], gbar, abar0), 2),
    }
    sites = B * S * L
    live = B * float((obs != -2).sum())
    for key, name in (("fwd", "smc_forward"), ("fwd_res", "smc_forward_residuals"),
                      ("bwd", "smc_backward")):
        t[key + "_bound"] = roofline.kernel_bound(name, M, B, S, L, live)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"timing at B={B} S={S} L={L} M={M} (float32); bounds: B1 {t['fwd_bound'][0]:.4f} ms "
          f"({t['fwd_bound'][1]}), B2 {t['fwd_res_bound'][0]:.4f} ms ({t['fwd_res_bound'][1]}), "
          f"B3 {t['bwd_bound'][0]:.4f} ms ({t['bwd_bound'][1]})")
    print(f"  plain: forward {t['fwd_plain']:.2f} ms, with residuals {t['fwd_res_plain']:.2f} ms, "
          f"adjoint {t['bwd_plain']:.2f} ms, forward + adjoint {t['fwd_grad_plain']:.2f} ms")
    _, _, ps = smc.forward_cuda(params, pi, obs, True)
    t["fwd"] = time_ms(torch, lambda: smc.forward_cuda(params, pi, obs, False), 20)
    t["fwd_res"] = time_ms(torch, lambda: smc.forward_cuda(params, pi, obs, True), 20)
    t["bwd"] = time_ms(torch, lambda: smc.backward_cuda(params, obs, ps, gbar, abar0), 20)
    t["fwd_grad"] = time_ms(torch, lambda: smc.backward_cuda(
        params, obs, smc.forward_cuda(params, pi, obs, True)[2], gbar, abar0), 20)
    geo = smc.kernel_geometry(B, S, M)
    print(f"  kernels: B1 {t['fwd']:.4f} ms   B2 {t['fwd_res']:.4f} ms   B3 {t['bwd']:.4f} ms   "
          f"B2 + B3 {t['fwd_grad']:.4f} ms ({sites / t['fwd_grad'] / 1e3:.1f} Msites/s)")
    print(f"  launch geometry: {B * S} instances of {geo['lanes_per_instance']} lanes "
          f"({geo['states_per_lane']} states a lane), {geo['instances_per_warp']} instances a "
          f"warp: {geo['warps']} warps in {geo['blocks']} blocks of "
          f"{geo['threads_per_block']} threads on {min(geo['blocks'], sms)} of {sms} SMs")
    for label, (fp, fpi, fobs) in fit_inputs.items():
        n, s_ = fpi.shape[:2]
        _, _, ps = smc.forward_cuda(fp, fpi, fobs, True)
        g = torch.randn(n, s_, generator=gen, device=dev)
        ab = torch.randn(n, s_, M, generator=gen, device=dev)
        t_fwd = time_ms(torch, lambda: smc.forward_cuda(fp, fpi, fobs, True), 20)
        t_bwd = time_ms(torch, lambda: smc.backward_cuda(fp, fobs, ps, g, ab), 20)
        print(f"  smc fit inputs, {label}: B2 {t_fwd:.4f} ms, B3 {t_bwd:.4f} ms; "
              f"smallest period-state entry {float(ps[ps > 0].min()):.3e}")
    return t


def time_graph_ms(torch, fn, reps: int = 20, replays: int = 5) -> float:
    """ms a call of `fn` on the card without the host's share: `reps` calls
    captured in one CUDA graph (after a warm call on a side stream), then
    `replays` replays timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def assembly_timing(torch, dev, prog) -> dict:
    """Phase 5, the assembly: A1 and A2 on the card (a CUDA graph of 20
    launches, replayed 5 times: the kernel without the wrapper's host time,
    as the fit's graphed step runs it; and eager, CUDA events around 20
    launches, mean) and their plain versions (mean of 2 calls after one
    warm-up) on the smc fit's program `prog` (its particles after the timed
    steps, float32, its AFS term: n - 1 = 1 from one diploid), then A1 and A2
    at n - 1 = 15 (the genome-file fit's n = 16); beside them the launch
    floor (a one-element add, both ways) and roofline.py's bounds."""
    from phlash_tpu_torch import roofline
    from phlash_tpu_torch.ops import assembly, build

    lib = build.load_library()
    init, x = prog.init, prog.state.particles.contiguous()
    P, D = x.shape
    M = init.M
    cases = {"fit": (prog.afs, prog.afs_transform)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    cases["n-1=15"] = assembly_afs(torch, 15, gen, x.dtype)
    t = {}
    for label, (afs, T) in cases.items():
        nm1 = 0 if afs is None else afs.shape[0]
        R = 0 if afs is None else (nm1 if T is None else T.shape[0])
        outs = assembly.forward_cuda(init, x, afs, T)
        g = tuple(torch.randn(o.shape, generator=gen, device=dev, dtype=x.dtype) for o in outs)
        key = "" if label == "fit" else "_n16"
        a1 = lambda: assembly.forward_cuda(init, x, afs, T)  # noqa: E731
        a2 = lambda: assembly.backward_cuda(init, x, afs, T, *g)  # noqa: E731
        t["a1" + key], t["a2" + key] = time_graph_ms(torch, a1), time_graph_ms(torch, a2)
        t["a1_eager" + key], t["a2_eager" + key] = time_ms(torch, a1, 20), time_ms(torch, a2, 20)
        if label == "fit":
            t["a1_plain"] = time_ms(torch, lambda: assembly.assemble_plain(init, x, afs, T), 2)
            t["a2_plain"] = time_ms(torch, lambda: assembly.assemble_vjp_plain(
                init, x, afs, T, *g), 2)
            for k, name in (("a1", "assembly_forward"), ("a2", "assembly_backward")):
                t[k + "_bound"] = roofline.assembly_bound(name, P, M, D, nm1, R,
                                                          x.element_size())
            t["shape"] = dict(P=P, M=M, D=D, n_minus_1=nm1, R=R, dtype=str(x.dtype))
        print(f"assembly timing, {label} (P={P}, M={M}, D={D}, n-1={nm1}, {x.dtype}): "
              f"A1 {t['a1' + key]:.4f} ms, A2 {t['a2' + key]:.4f} ms a launch by graph replay; "
              f"eager A1 {t['a1_eager' + key]:.4f} ms, A2 {t['a2_eager' + key]:.4f} ms")
    one = torch.zeros(1, device=dev)
    t["launch_floor"] = time_ms(torch, lambda: one.add_(1.0), 20)
    t["launch_floor_graph"] = time_graph_ms(torch, lambda: one.add_(1.0))
    print(f"  bounds: A1 {t['a1_bound'][0]:.6f} ms ({t['a1_bound'][1]}), A2 "
          f"{t['a2_bound'][0]:.6f} ms ({t['a2_bound'][1]}); launch floor (a one-element add) "
          f"{t['launch_floor']:.4f} ms eager, {t['launch_floor_graph']:.4f} ms by graph replay")
    print(f"  plain: A1's {t['a1_plain']:.2f} ms, A2's {t['a2_plain']:.2f} ms")
    regs = ptxas_report(lib.ptxas_log)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t["geometry"] = {}
    for k, name in (("A1", "assembly_forward_kernel"), ("A2", "assembly_backward_kernel")):
        shape = t["shape"]
        geo = assembly.kernel_geometry(M, shape["n_minus_1"], shape["R"], x.dtype, k == "A2")
        blocks = -(-P // geo["warps_per_block"])
        r, spill = regs.get(f"{name}<{'float' if x.dtype == torch.float32 else 'double'}>",
                            (None, None))
        t["geometry"][k] = dict(geo, blocks=blocks, warps=P, registers=r,
                                spill_store_bytes=spill)
        print(f"  launch geometry: {k} a warp ({geo['lanes_per_particle']} lanes) a particle: "
              f"{P} warps in {blocks} blocks of {geo['warps_per_block']} warps on "
              f"{min(blocks, sms)} of {sms} SMs, {geo['shared_bytes_per_block']} shared bytes a "
              f"block ({geo['shared_bytes_per_particle']} a particle); ptxas: {r} registers, "
              f"{spill} bytes spill stores")
    return t


def packed_timing(torch, packed, dev, fit_inputs: dict):
    """Phase 5b: the packed kernels and their plain versions at the fit
    shape, float32, with the kernels' launch geometry; then the kernels on
    `fit_inputs` (label -> packed_fit_inputs' triple)."""
    from phlash_tpu_torch import roofline
    from phlash_tpu_torch.ops.packing import dense_transition
    from phlash_tpu_torch.params import PSMCParams

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    (B, S, L), M = FIT_SHAPE, 16
    params, pi, obs = random_instances(torch, M, B, S, L, dev, gen)
    obs[obs == -2] = 0  # the fit's rows carry no padding
    A, e0, e1, pi = (x.float().contiguous() for x in (
        dense_transition(PSMCParams(*params, pi=pi)), *params[4:], pi))
    gbar = torch.randn(B, S, generator=gen, device=dev)
    _, ck = packed.forward_packed_cuda(A, e0, e1, pi, obs)
    _, ck_p = packed.forward_packed(A, e0, e1, pi, obs)
    t = {
        "fwd": time_ms(torch, lambda: packed.forward_packed_cuda(A, e0, e1, pi, obs,
                                                                 with_ckpt=False), 20),
        "fwd_plain": time_ms(
            torch, lambda: packed.forward_packed(A, e0, e1, pi, obs, with_ckpt=False), 2),
        "bwd": time_ms(torch, lambda: packed.backward_packed_cuda(A, e0, e1, obs, ck, gbar), 20),
        "bwd_plain": time_ms(
            torch, lambda: packed.backward_packed(A, e0, e1, obs, ck_p, gbar), 2),
    }
    t["fwd_ckpt"] = time_ms(torch, lambda: packed.forward_packed_cuda(A, e0, e1, pi, obs), 20)
    t["fwd_grad"] = time_ms(torch, lambda: packed.backward_packed_cuda(
        A, e0, e1, obs, packed.forward_packed_cuda(A, e0, e1, pi, obs)[1], gbar), 20)
    t["fwd_grad_plain"] = time_ms(torch, lambda: packed.backward_packed(
        A, e0, e1, obs, packed.forward_packed(A, e0, e1, pi, obs)[1], gbar), 2)
    sites = B * S * L
    live = B * float((obs != -2).sum())
    for key, name in (("fwd", "packed_forward"), ("bwd", "packed_backward")):
        t[key + "_bound"] = roofline.kernel_bound(name, M, B, S, L, live)
    print(f"packed timing at B={B} S={S} L={L} M={M} seg_len={packed.DEFAULT_SEG} (float32):")
    for key, what in (("fwd", "forward, no checkpoints"), ("bwd", "adjoint alone"),
                      ("fwd_grad", "forward with checkpoints + adjoint")):
        extra = f"   bound {t[key + '_bound'][0]:.4f} ms" if key + "_bound" in t else ""
        print(f"  {what:<35} kernel {t[key]:.4f} ms ({sites / t[key] / 1e3:.1f} Msites/s)   "
              f"plain {t[key + '_plain']:.2f} ms ({sites / t[key + '_plain'] / 1e3:.3f} Msites/s)"
              f"{extra}")
    print(f"  forward with checkpoints            kernel {t['fwd_ckpt']:.4f} ms")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, geo in packed.kernel_geometry(B, S).items():
        print(f"  {name} launch geometry: {B * S} instances of {geo['lanes_per_instance']} lanes "
              f"({geo['states_per_lane']} states a lane), {geo['instances_per_warp']} instances "
              f"a warp: {geo['warps']} warps in {geo['blocks']} blocks of "
              f"{geo['threads_per_block']} threads on {min(geo['blocks'], sms)} of {sms} SMs")

    # the same launches on the packed fit's own inputs, at its initial cloud
    # and after the timed steps: the kernels' time depends on the data
    for label, (fp, fpi, fobs) in fit_inputs.items():
        fA = dense_transition(PSMCParams(*fp, pi=fpi)).contiguous()
        fe0, fe1 = fp[4:]
        fg = torch.randn(fpi.shape[:2], generator=gen, device=dev)
        _, fck = packed.forward_packed_cuda(fA, fe0, fe1, fpi, fobs)
        t_fwd = time_ms(torch, lambda: packed.forward_packed_cuda(
            fA, fe0, fe1, fpi, fobs, with_ckpt=False), 20)
        t_bwd = time_ms(torch, lambda: packed.backward_packed_cuda(fA, fe0, fe1, fobs, fck, fg),
                        20)
        print(f"  fit inputs, {label}: forward {t_fwd:.4f} ms, adjoint {t_bwd:.4f} ms; "
              f"smallest checkpoint entry {float(fck[fck > 0].min()):.3e}")
    return t


# phase 7: genome files.  Two contigs of GENOME_WINDOWS windows of 100 bp
# (50 Mb each) of GENOME_SAMPLES diploids from the continuous SMC' under the
# bottleneck, written as .vcf.gz with .tbi, .vcf and .bcf with .csi
GENOME_WINDOWS = 500_000
GENOME_SAMPLES = 8
GENOME_CONTIGS = ("chr1", "chr2")
HOM_ALT = 0.25  # chance that a sample not het at a record is 1|1 there (else 0|0)
GT_TEXT = ("0|0", "0|1", "1|1")  # by derived-allele count
GT_ALLELES = ((0, 0), (0, 1), (1, 1))
GENOME_FIT = dict(num_particles=500, niter=NITER, overlap=500, chunk_size=2000, num_workers=2)
CLI_NITER = 20


def genome_records(het, rng, window_size: int = 100):
    """One contig's records: one in each window where any sample is het, at
    a random position inside it; a sample is 0|1 where its window is het,
    else 1|1 with probability HOM_ALT and 0|0 otherwise.  Returns 1-based
    positions (R,) and each call's derived-allele count (R, S) in 0..2."""
    import numpy as np

    w = np.flatnonzero(het.any(0))
    pos = 1 + window_size * w + rng.integers(0, window_size, len(w))
    hom_alt = rng.random((len(w), het.shape[0])) < HOM_ALT
    return pos, np.where(het[:, w].T > 0, 1, np.where(hom_alt, 2, 0))


def spectrum(code):
    "The AFS (n - 1,) of records with derived-allele counts `code` (R, S)."
    import numpy as np

    n = 2 * code.shape[1]
    return np.bincount(code.sum(1), minlength=n + 1)[1:-1]


def write_genome_files(out: Path, planted: dict, samples: list[str], seed: int,
                       window_size: int = 100) -> tuple[dict, dict, dict]:
    """Write the contigs' records as out/genome.vcf.gz (+ .tbi), genome.vcf
    and genome.bcf (+ .csi) with the port's writers.  `planted` maps a
    contig name to its (S, W) het matrix.  Returns (paths, the AFS the
    records carry by contig, seconds by form)."""
    import numpy as np

    from phlash_tpu_torch.io.bcf import write_bcf
    from phlash_tpu_torch.io.tabix import write_tabixed_vcf

    rng = np.random.default_rng(seed)
    header = ("##fileformat=VCFv4.2\n"
              '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
              + "".join(f"##contig=<ID={c},length={h.shape[1] * window_size}>\n"
                        for c, h in planted.items())
              + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + "\t".join(samples) + "\n")
    lines, bcf_records, spectra = [header], [], {}
    for chrom, het in planted.items():
        pos, code = genome_records(het, rng, window_size)
        spectra[chrom] = spectrum(code)
        for p, row in zip(pos.tolist(), code.tolist()):
            lines.append(f"{chrom}\t{p}\t.\tA\tT\t.\tPASS\t.\tGT\t"
                         + "\t".join(GT_TEXT[k] for k in row) + "\n")
            bcf_records.append((chrom, p, "A", ["T"], [GT_ALLELES[k] for k in row]))
    text = "".join(lines)
    paths = {form: out / f"genome.{form}" for form in ("vcf.gz", "vcf", "bcf")}
    seconds = {}
    t0 = time.perf_counter()
    write_tabixed_vcf(str(paths["vcf.gz"]), text)
    seconds["vcf.gz"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths["vcf"].write_text(text)
    seconds["vcf"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_bcf(str(paths["bcf"]), header, bcf_records, index=True)
    seconds["bcf"] = time.perf_counter() - t0
    return paths, spectra, seconds


def check_ingestion(paths: dict, planted: dict, spectra: dict, samples: list[str],
                    chrom: str, window_size: int = 100) -> dict:
    """Phase 7b: contig(path, samples, region).get_data() of each form over the
    whole of `chrom` must give the planted het matrix and the records' AFS
    exactly, through the C tokenizer and the native BCF reader with no
    warning.  Returns the seconds of each form."""
    import numpy as np

    from phlash_tpu_torch.data import contig
    from phlash_tpu_torch.io import vcf_parser_backend

    if vcf_parser_backend() != "c":
        fail("the C VCF tokenizer did not build (vcf_parser_backend() is not 'c')")
    log, warned = logging.getLogger("phlash_tpu_torch.data"), Records(logging.WARNING)
    log.addHandler(warned)
    region = f"{chrom}:1-{planted[chrom].shape[1] * window_size}"
    seconds = {}
    try:
        for form, path in paths.items():
            t0 = time.perf_counter()
            d = contig(str(path), samples, region).get_data(window_size)
            seconds[form] = time.perf_counter() - t0
            if not np.array_equal(d["het_matrix"], planted[chrom].astype(np.int8)):
                fail(f"genome.{form} {region}: the het matrix is not the planted one")
            if not np.array_equal(d["afs"], spectra[chrom]):
                fail(f"genome.{form} {region}: AFS {d['afs'].tolist()}, "
                     f"the records carry {spectra[chrom].tolist()}")
    finally:
        log.removeHandler(warned)
    if warned.records:
        fail(f"ingestion warned: {[r.getMessage() for r in warned.records]}")
    return seconds


def afs_term_precision(torch, prog) -> dict:
    """The AFS term of prog's initial cloud in its float32 against float64
    (the same particles, cast): max relative difference over the particles."""
    from phlash_tpu_torch.model import log_afs

    x = prog.state.particles
    a32 = log_afs(prog.init.unflatten(x).to_dm().eta, prog.afs, prog.afs_transform)
    init64 = prog.init.to(dtype=torch.float64)
    a64 = log_afs(init64.unflatten(x.double()).to_dm().eta, prog.afs.double(),
                  prog.afs_transform.double())
    rel = float(((a32.double() - a64).abs() / a64.abs()).max())
    return dict(n=int(prog.afs.shape[-1]) + 1, f32_median=float(a32.median()),
                f64_median=float(a64.median()), max_rel=rel)


def genome_phase(torch, ops: dict, dev, tmp: str) -> dict:
    """Phase 7: from genome files to a posterior.  (a) simulate and write
    the files; (b) the ingestion gates; (c) phlash_tpu_torch.fit from the
    .vcf.gz with a spawn pool of 2 readers, by graph replay with the fused
    ELPD on chr2, with exact launch counts; (d) the command line in-process.
    Returns the fit's launch counts, by ops module."""
    import numpy as np

    import phlash_tpu_torch
    from phlash_tpu_torch import results, sim
    from phlash_tpu_torch.__main__ import main as cli
    from phlash_tpu_torch.data import contig, init_mcmc_data
    from phlash_tpu_torch.mcmc import generators
    from phlash_tpu_torch.training import build_training

    out = Path(tmp) / "genome"
    out.mkdir()
    samples = [f"s{i}" for i in range(GENOME_SAMPLES)]
    truth = sim.bottleneck_demography()
    t0 = time.perf_counter()
    planted = {c: sim.simulate_smc_continuous(truth, L=GENOME_WINDOWS, n_samples=GENOME_SAMPLES,
                                              seed=SEED + 70 + k).het_matrix
               for k, c in enumerate(GENOME_CONTIGS)}
    t_sim = time.perf_counter() - t0
    paths, spectra, t_write = write_genome_files(out, planted, samples, SEED + 79)
    print(f"genome: {len(planted)} contigs x {GENOME_WINDOWS} windows x {GENOME_SAMPLES} "
          f"samples simulated in {t_sim:.2f} s; records "
          f"{ {c: int(h.any(0).sum()) for c, h in planted.items()} }; written in "
          + ", ".join(f"{f} {s:.2f} s ({paths[f].stat().st_size} B)" for f, s in t_write.items()))
    print(f"genome: AFS (n = {2 * GENOME_SAMPLES}) of chr1 {spectra['chr1'].tolist()}")

    # b. ingestion gates
    t_read = check_ingestion(paths, planted, spectra, samples, "chr1")
    print("genome: chr1 ingested equal to the planted het matrix and AFS (C tokenizer, "
          "native BCF): " + ", ".join(f"{f} {s:.3f} s" for f, s in t_read.items()))

    # c. the fit: chr1 as its two arms (so that the pool has two contigs to
    # read), chr2 held out
    end = GENOME_WINDOWS * 100
    half = end // 2
    vcf_gz = str(paths["vcf.gz"])
    train = [contig(vcf_gz, samples, f"chr1:1-{half}"), contig(vcf_gz, samples,
                                                               f"chr1:{half + 1}-{end}")]
    test = contig(vcf_gz, samples, f"chr2:1-{end}")
    mlog, fitlog = logging.getLogger("phlash_tpu_torch"), Records()  # mcmc's and data's
    level = mlog.level
    mlog.addHandler(fitlog)
    mlog.setLevel(logging.DEBUG)
    try:
        for mod in ops.values():
            mod.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post = phlash_tpu_torch.fit(train, test_data=test, device="cuda", seed=SEED + 7,
                                    progress=False, **GENOME_FIT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: mod.counts() for name, mod in ops.items()}
    finally:
        mlog.removeHandler(fitlog)
        mlog.setLevel(level)
    check_counts(counts, expected_counts("smc"), "the genome-file fit")
    if len(post) != GENOME_FIT["num_particles"] or not all(
            torch.isfinite(m.eta.t).all() and torch.isfinite(m.eta.c).all()
            and (m.eta.c > 0).all() and np.isfinite(m.rho) for m in post):
        fail(f"the genome-file fit did not return {GENOME_FIT['num_particles']} finite models")
    if not any(r.getMessage().startswith("reading 2 contigs in a pool") for r in fitlog.records):
        fail("the genome-file fit did not read its contigs in the worker pool")
    down = [r.args for r in fitlog.records if r.getMessage().startswith("downsampling chunks")]
    meter = fitlog.meters[-1]
    loop_s = GENOME_FIT["niter"] / meter["steps_per_sec"]
    ms_iter = 1e3 * (loop_s - meter["setup_seconds"]) / GENOME_FIT["niter"]
    # the AFS term of an initial cloud drawn as the fit draws its own, on
    # the chunks before the cap
    afs, chunks = init_mcmc_data(train, 100, GENOME_FIT["overlap"], GENOME_FIT["chunk_size"],
                                 num_workers=1)
    prog = build_training(chunks, afs, window_size=100, overlap=GENOME_FIT["overlap"],
                          options=dict(GENOME_FIT, minibatch_size=5), device=dev,
                          generator=generators(SEED + 7, dev)[0], kernel_backend="smc")
    prec = afs_term_precision(torch, prog)
    line = dict(phase="genome", wall_s=wall, setup_s=meter["setup_seconds"],
                ms_per_iter_without_setup=ms_iter, chunks_before_after_cap=down[0] if down
                else [len(chunks)] * 2, launches=counts, afs_term=prec,
                ingest_s=t_read, write_s=t_write)
    print(f"genome fit: {len(post)} finite models in {wall:.2f} s (reading, chunking, "
          f"graph set-up {meter['setup_seconds']:.3f} s included); {ms_iter:.3f} ms an "
          f"iteration without set-up; chunks {line['chunks_before_after_cap']} before / after "
          f"the 5*S*niter cap; launches {counts}")
    print(f"genome fit: AFS term of the initial cloud (n = {prec['n']}), float32 against "
          f"float64: max relative difference {prec['max_rel']:.3e}")
    if not prec["max_rel"] <= 1e-5:
        fail(f"the float32 AFS term is off its float64 value by {prec['max_rel']:.3e} > 1e-5")

    # d. the command line, in this process
    post_path = out / "post.npz"
    for mod in ops.values():
        mod.reset_counts()
    t0 = time.perf_counter()
    rc = cli(["fit", vcf_gz, vcf_gz, "--region", f"chr2:1-{end}", "--region", f"chr1:1-{end}",
              "--samples", *samples, "--hold-out", "--niter", str(CLI_NITER),
              "--particles", str(GENOME_FIT["num_particles"]),
              "--out", str(post_path), "--seed", "1"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_counts = {name: mod.counts() for name, mod in ops.items()}
    models = results.load_posterior(str(post_path))
    print(f"genome cli: exit {rc} in {cli_s:.2f} s; {len(models)} models read back from "
          f"{post_path.name}; launches {cli_counts}")
    if rc != 0 or len(models) != GENOME_FIT["num_particles"]:
        fail(f"the command line exited {rc} and wrote {len(models)} models")
    check_counts(cli_counts, expected_counts("smc", CLI_NITER), "the command line's fit")
    line.update(cli_s=cli_s, cli_launches=cli_counts)
    print(json.dumps(line))
    return counts


# phase 8b: the simulator at chromosome scale, then the canonical end-to-end drive
SIM_L = 10_000_000
DRIVE = dict(niter=40, num_particles=24, overlap=100, chunk_size=2000, num_workers=1,
             progress=False, elpd_cutoff=30)

# two ranks of one NCCL group on the one device (phase 8a)
NCCL_PROBE = """
import datetime, sys, torch, torch.distributed as dist
rank, store = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="file://" + store, rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
t = torch.ones(1, device="cuda")
dist.all_reduce(t)
torch.cuda.synchronize()
print("two ranks on one device: all_reduce gave", t.item())
dist.destroy_process_group()
"""


def nccl_two_ranks(tmp: str, seconds: float = 180.0) -> list[str]:
    """Start two NCCL ranks on device 0 and report what they print (NCCL
    refuses a duplicate GPU); every process is killed at the deadline."""
    store = Path(tmp) / "nccl_probe_store"
    procs = [subprocess.Popen([sys.executable, "-c", NCCL_PROBE, str(r), str(store)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    deadline = time.monotonic() + seconds
    report = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0] + f"\n(killed after {seconds:.0f} s)"
        keep = [ln for ln in out.splitlines()
                if "Duplicate GPU" in ln or "two ranks on one device" in ln or "killed" in ln]
        report.append(f"rank {r} exit {p.returncode}: "
                      + (" | ".join(keep[:2]) or " | ".join(out.strip().splitlines()[-2:])))
    return report


def mesh_phase(torch, ops: dict, dev, tmp: str, want: dict, progs: dict) -> dict:
    """Phase 8a: phase 4's fits with mesh=make_mesh(1) (NCCL, world size 1):
    exact launch counts, particles against phase 4's `want` models, the
    collectives, graphed ms an iteration in turns with phase 4c's unsharded
    programs `progs`, and the two-ranks-on-one-device probe.  Returns each
    path's launch counts."""
    import torch.distributed as dist

    import phlash_tpu_torch
    from phlash_tpu_torch.parallel import make_mesh, mesh as comms

    mesh = make_mesh(1)
    print(f"mesh: {tuple(mesh.mesh.shape)} (p, d) over {dist.get_backend()}, world size "
          f"{dist.get_world_size()}, device {torch.cuda.current_device()}")
    path = Path(tmp) / "smoke.psmcfa"
    write_psmcfa(path)
    out = {}
    for backend, overlap in PATHS:
        for mod in (*ops.values(), comms):
            mod.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models = phlash_tpu_torch.psmc([str(path)], device="cuda", kernel_backend=backend,
                                       niter=NITER, overlap=overlap, mesh=mesh, **SLICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: mod.counts() for name, mod in ops.items()}
        colls = comms.collectives()
        check_counts(counts, expected_counts(backend), f"the meshed {backend} fit")
        step_keys = ("all_reduce/d/rows", "all_reduce/d/density", "all_gather/p/cloud")
        if any(colls.get(k, (0, 0))[0] != NITER + 1 for k in step_keys):
            fail(f"the meshed {backend} fit ran {colls}; expected {NITER + 1} of each of "
                 f"{step_keys} (the iterations and the capture's eager warm-up)")
        step_bytes = sum(colls[k][1] for k in step_keys)
        err = max(max(max_rel(g.eta.c, w.eta.c), max_rel(g.eta.t, w.eta.t))
                  for g, w in zip(models, want[backend]))
        same = all(torch.equal(g.eta.c, w.eta.c) and torch.equal(g.eta.t, w.eta.t)
                   for g, w in zip(models, want[backend]))
        print(f"mesh {backend}: psmc(niter={NITER}, overlap={overlap}, mesh=make_mesh(1)) took "
              f"{wall:.2f} s; launch counts {counts}; against phase 4's unsharded "
              f"fit: max rel err {err:.3e} over eta.c and eta.t, bitwise equal: {same}")
        print(f"mesh {backend}: collectives (calls, bytes a call) {colls}; {step_bytes} B an "
              "SVGD iteration")
        if len(models) != len(want[backend]) or not err <= 1e-6:
            fail(f"the meshed {backend} fit differs from the unsharded one by {err:.3e}")
        out[backend] = dict(launches=counts, max_rel_err=err, bitwise=same,
                            collectives=colls, bytes_per_iter=step_bytes, wall_s=wall)

    # graphed ms an iteration, unsharded and meshed, in turns
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    for backend, overlap in PATHS:
        meshed = build_program(torch, dev, path, backend, overlap, mesh=mesh)[0]
        ms = {"unsharded": [], "mesh": []}
        for which in ("unsharded", "mesh", "mesh", "unsharded"):
            prog = progs[backend] if which == "unsharded" else meshed
            ms[which].append(time_graphed(torch, prog, gen)[0])
        for (k, elpd), sec in meshed.step.setup_seconds.items():
            print(f"mesh {backend}: graph ({k} iterations, ELPD {elpd}) warm-up "
                  f"{sec['warmup']:.3f} s, capture and instantiation {sec['capture']:.3f} s")
        print(f"mesh {backend}: graphed ms an iteration in turns (unsharded, mesh, mesh, "
              f"unsharded): {ms['unsharded'][0]:.3f}, {ms['mesh'][0]:.3f}, {ms['mesh'][1]:.3f}, "
              f"{ms['unsharded'][1]:.3f}")
        out[backend]["graphed_ms"] = ms
    out["two_ranks_one_device"] = nccl_two_ranks(tmp)
    for line in out["two_ranks_one_device"]:
        print(f"mesh: NCCL, {line}")
    print(json.dumps(dict(phase="mesh", **{b: {k: v for k, v in out[b].items()
                                               if k != "collectives"} for b, _ in PATHS})))
    return {b: out[b]["launches"] for b, _ in PATHS}


def sim_phase(torch, dev, tmp: str) -> dict:
    """Phase 8b: simulate_hmm at L = SIM_L on the card, its law, and the
    canonical end-to-end drive on the port (as phlash_tpu's: bottleneck
    truth, 3 x 20,000 windows, 24 particles, 40 iterations)."""
    import numpy as np

    import phlash_tpu_torch
    from phlash_tpu_torch import sim

    dm = sim.bottleneck_demography()
    seconds = []
    for k in range(2):  # the first call includes the lazy start of its CUDA kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        contig = sim.simulate_hmm(dm, SIM_L, seed=SEED + 90 + k)
        seconds.append(time.perf_counter() - t0)
    A, pi, e1 = sim.hmm_arrays(dm, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, obs = sim.simulate_path(A, pi, e1, SIM_L, torch.Generator(device=dev).manual_seed(
        SEED + 92))
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    An, e1n = A.cpu().numpy(), e1.cpu().numpy()
    st = sim.hmm_path_stats(states.cpu().numpy(), obs.cpu().numpy(), An, e1n)
    het = float((contig.het_matrix == 1).mean())
    print(f"simulate_hmm: L={SIM_L} on the card in {seconds[0]:.3f} s (first call), "
          f"{seconds[1]:.3f} s (second), host copy included; het rate {het:.6f} against "
          f"sum pi' emis1 {st['het_expected']:.6f} +- {st['het_se']:.2e} (one standard error)")
    print(f"simulate_hmm: a path of {SIM_L} states ({t_path:.3f} s): het rate "
          f"{st['het_rate']:.6f}; state marginal chi2 {st['marginal_chi2']:.2f} on "
          f"{st['marginal_cells'] - 1} df, p {st['marginal_p']:.3g}; transitions chi2 "
          f"{st['transition_chi2']:.1f} on {st['transition_df']} df, p {st['transition_p']:.3g}")
    if contig.het_matrix.shape != (1, SIM_L) or abs(het - st["het_expected"]) > 4 * st["het_se"]:
        fail("simulate_hmm's het rate is off its law by more than 4 standard errors")
    if abs(st["het_rate"] - st["het_expected"]) > 4 * st["het_se"]:
        fail("the path's het rate is off its law by more than 4 standard errors")
    if not (st["marginal_p"] > 1e-3 and st["transition_p"] > 1e-3):
        fail("the simulated path disagrees with its HMM by chi-square")

    # the canonical end-to-end drive, on the port
    truth = sim.bottleneck_demography(theta=1e-2)
    code = np.array(["N", "T", "K"])
    psmcfa = Path(tmp) / "s.psmcfa"
    with open(psmcfa, "w") as f:
        for i in range(3):
            c = sim.simulate_hmm(truth, L=20_000, seed=i)
            f.write(f">chr{i}\n" + "".join(code[c.het_matrix[0] + 1]) + "\n")
    t0 = time.perf_counter()
    post = phlash_tpu_torch.psmc([str(psmcfa)], device="cuda", **DRIVE)
    wall = time.perf_counter() - t0
    c = torch.stack([m.eta.c for m in post])
    med = float(c.median())
    print(f"canonical drive: psmc on 3 x 20,000 simulated windows, {len(post)} models in "
          f"{wall:.2f} s; posterior median of c {med:.4f} (median over particles a epoch: "
          f"{[f'{x:.3g}' for x in c.median(0).values.tolist()]})")
    if len(post) != DRIVE["num_particles"] or not 0.5 <= med <= 2.0:
        fail(f"the canonical drive's posterior median of c is {med:.4f}, outside [0.5, 2]")
    line = dict(phase="simulate_hmm", L=SIM_L, seconds=seconds, simulate_hmm_het_rate=het,
                path_seconds=t_path, path=st, drive_median_c=med, drive_s=wall)
    print(json.dumps(line))
    return line


def trace_phase(torch, prog, dev, tmp: str) -> dict:
    """Phase 8c: profiling.trace around one graphed call of `prog` (the smc
    program): the trace file exists and names the smc kernels."""
    from phlash_tpu_torch.profiling import trace
    from phlash_tpu_torch.training import clone_state

    gen = torch.Generator(device=dev).manual_seed(SEED + 95)
    inds = torch.randint(prog.N, (prog.steps_per_call, prog.S), generator=gen, device=dev)
    state = prog.state
    with trace(str(Path(tmp) / "trace")) as log_dir:
        state, _ = prog.step(state, inds)
        torch.cuda.synchronize()
    prog.state = clone_state(state)
    files = sorted(Path(log_dir).glob("*.pt.trace.json"))
    text = files[0].read_text() if files else ""
    names = {k: text.count(k) for k in ("smc_forward_kernel", "smc_backward_kernel",
                                         "cudaGraphLaunch")}
    print(f"trace: {len(files)} file(s) under the log directory, "
          f"{files[0].name if files else None} ({len(text)} B); mentions {names}")
    if len(files) != 1 or not (names["smc_forward_kernel"] and names["smc_backward_kernel"]):
        fail("profiling.trace wrote no trace naming the smc kernels")
    return names


# phase 9: the bench's deadline, and what each of its timed windows must launch
BENCH_SECONDS = 600
# (kernel -> launches per unit: an smc SVGD iteration runs B2 and B3 twice,
# the filter and the likelihood, and A1 and A2 once)
_SMC_SVGD = {"B2": 2, "B3": 2, "A1": 1, "A2": 1}
_PACKED_SVGD = {"B4": 1, "B5": 1, "A1": 1, "A2": 1}
BENCH_WINDOWS = {"fwd_only": {"B1": 1}, "fwd_grad": {"B2": 1, "B3": 1},
                 "m32_fwd_only": {"B1": 1}, "m32_fwd_grad": {"B2": 1, "B3": 1},
                 "m64_fwd_only": {"B1": 1}, "m64_fwd_grad": {"B2": 1, "B3": 1},
                 "packed_fwd_only": {"B4": 1}, "packed_fwd_grad": {"B4": 1, "B5": 1},
                 "smc_svgd_first_call": _SMC_SVGD, "smc_svgd": _SMC_SVGD,
                 "packed_svgd_first_call": _PACKED_SVGD, "packed_svgd": _PACKED_SVGD,
                 "assembly_fwd": {"A1": 1}, "assembly_grad": {"A2": 1}, "baseline": {}}


def bench_phase(card_name: str) -> dict:
    """Phase 9: `python -m phlash_tpu_torch bench` in a subprocess from the
    checkout's root, killed at BENCH_SECONDS; echoes its line and holds it
    to its gate, its launch windows, its roofline shares and the card's
    name.  Returns the bench's launches of each kernel over its windows."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-m", "phlash_tpu_torch", "bench"], cwd=ROOT,
                             capture_output=True, text=True, timeout=BENCH_SECONDS)
    except subprocess.TimeoutExpired:
        fail(f"the bench did not finish in {BENCH_SECONDS} s")
    wall = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    for line in lines:
        print(f"bench: {line}")
    if out.returncode != 0 or len(lines) != 1:
        print(out.stderr[-4000:], file=sys.stderr)
        fail(f"the bench exited {out.returncode} with {len(lines)} lines on its standard output")
    res = json.loads(lines[0])
    extra = res["extra"]
    gate = extra["gate"]
    e_g = max(gate["max_normalized_err_grad"].values())
    print(f"bench: {wall:.1f} s; value {res['value']} Msites/s fwd+grad, vs_baseline "
          f"{res['vs_baseline']}; gate ll {gate['max_rel_err_ll']:.3e}, gradients {e_g:.3e}; "
          f"card {extra['device_name']}, {extra['power_limit']}; SM clock "
          f"{extra['clocks_sm_mhz']} MHz, power draw {extra['power_draw_w']} W")
    if not (gate["ok"] and gate["max_rel_err_ll"] <= 1e-5 and e_g <= 2e-5):
        fail(f"the bench's gate failed: {gate}")
    if res["value"] is None:
        fail("the bench printed no value")
    windows = extra["launches"]
    if set(windows) != set(BENCH_WINDOWS):
        fail(f"the bench timed the windows {sorted(windows)}; expected {sorted(BENCH_WINDOWS)}")
    for name, kernels in BENCH_WINDOWS.items():
        got = windows[name]
        units = {got[k] / n for k, n in kernels.items() if k in got}
        if set(got) != set(kernels) or len(units) > 1 or not all(got.values()):
            fail(f"the bench's {name} window launched {got}; expected {kernels} in proportion "
                 "(each at least once), and nothing else")
    shares = {k: v for k, v in extra.items() if "roofline_fraction" in k}
    if len(shares) != 4 or not all(v is not None and 0.0 < v <= 1.0 for v in shares.values()):
        fail(f"the bench's roofline shares are not all in (0, 1]: {shares}")
    issue = {k: v for k, v in extra.items() if k.startswith("sm_") and "peak_fraction" in k}
    if len(issue) != 4 or not all(v is not None and 0.0 < v <= 1.0 for v in issue.values()):
        fail(f"the bench's issue and shuffle shares are not all in (0, 1]: {issue}")
    if extra["device_name"] != card_name:
        fail(f"the bench names the card {extra['device_name']!r}; phase 1 read {card_name!r}")
    total = {}
    for got in windows.values():
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
    print(f"bench: roofline shares {shares}; issue and shuffle shares {issue}; launches over "
          f"its windows {total}; assembly "
          f"at {extra['assembly_particles']} particles: A1 {extra['assembly_fwd_ms']:.4f} ms, "
          f"A2 {extra['assembly_grad_ms']:.4f} ms a launch")
    return total


# phase 10: B6, the issue-rate micro-kernels (ops/peak.py, csrc/peak.cu).
# The card check's launch of each configuration: copies and threads a block
PEAK_CHECK_GEOMETRY = ((2, 128), (3, 32))


def check_peak(torch, dev) -> dict:
    """Phase 10a: every built micro-kernel against its plain version on the
    card, on the TPU tool's inputs drawn with numpy from SEED, in two
    launches (PEAK_CHECK_GEOMETRY) at each of two step counts: the TPU
    tool's INNER, and ops/peak.SHORT, where every entry must be finite (at
    INNER roll is +inf everywhere and multiport's rolled streams are back
    where they began, so only SHORT tests the shuffle's lane, wrap and
    direction).  ops/peak.compare on every copy (non-finite entries equal in
    position and sign, finite ones within rtol 1e-4 for mix and 1e-5 for the
    rest) and the copies bitwise equal.  Every configuration is checked and
    printed before a failure ends the phase.  Returns the gate's worst
    readings by kernel."""
    from phlash_tpu_torch.ops import peak

    a, b, c = peak.inputs(SEED, dev)
    worst, failures = {}, []
    for which, configs in peak.CONFIGS.items():
        w = worst[which] = dict(max_rel_err=0.0, max_abs_err=0.0, n_nonfinite=0,
                                rtol=peak.MIX_RTOL if which == "mix" else peak.RTOL,
                                copies_bitwise_equal=True, bitwise_equal_to_plain=True)
        for streams, unroll in configs:
            for inner in (peak.INNER, peak.SHORT):
                want = peak.reference(which, streams, unroll, a, b, c, inner)
                for copies, threads in PEAK_CHECK_GEOMETRY:
                    got = peak.run_cuda(which, streams, unroll, a, b, c, copies, threads, inner)
                    torch.cuda.synchronize()
                    g = peak.compare(which, got, want)
                    same = all(torch.equal(got[0], got[i]) for i in range(1, copies))
                    finite = inner == peak.INNER or g["n_nonfinite"] == 0
                    w["max_rel_err"] = max(w["max_rel_err"], g["max_rel_err"])
                    w["max_abs_err"] = max(w["max_abs_err"], g["max_abs_err"])
                    w["n_nonfinite"] = max(w["n_nonfinite"], g["n_nonfinite"])
                    w["copies_bitwise_equal"] &= same
                    w["bitwise_equal_to_plain"] &= bool(torch.equal(got[0], want))
                    if not (g["ok"] and same and finite):
                        failures.append(f"{which} s={streams} u={unroll} inner={inner} ({copies} "
                                        f"copies, {threads} threads a block): {g}, copies "
                                        f"bitwise equal {same}")
                print(f"peak {which} s={streams} u={unroll} inner={inner}: max rel err "
                      f"{g['max_rel_err']:.3e} (rtol {g['rtol']:g}), {g['n_nonfinite']} non-finite "
                      f"entries (equal in position and sign: {g['nonfinite_match']}), bitwise "
                      f"equal to the plain version: {bool(torch.equal(got[0], want))}, copies "
                      f"bitwise equal: {same}")
    if failures:
        fail("micro-kernels disagree with their plain version: " + "; ".join(failures))
    return worst


def peak_phase(torch, dev, lib) -> dict:
    """Phase 10: the micro-kernels' registers and spills, the card check
    (check_peak), then ops/peak.sweep, every configuration in both regimes,
    with the launch counter set to 0 just before it and read just after;
    the sweep's lines, the best rate of each micro-kernel, the maximum and
    B1-B3 at the measured mix plateau, beside the card's name, power limit
    and SM clock; then the plain version's time on the maximum's work."""
    from phlash_tpu_torch.ops import peak

    for (which, s, u), (regs, spill) in sorted(peak.ptxas_report(lib.ptxas_log).items()):
        print(f"peak ptxas: {which} s={s} u={u}: {regs} registers, {spill} bytes spill stores")
    t0 = time.perf_counter()
    gates = check_peak(torch, dev)
    t1 = time.perf_counter()
    a, b, c = peak.inputs(SEED, dev)
    query = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"]
    before = subprocess.run(query, capture_output=True, text=True, timeout=60).stdout.strip()
    peak.reset_counts()
    results = peak.sweep(a, b, c)
    launches = peak.counts()["run_cuda"]
    after = subprocess.run(query, capture_output=True, text=True, timeout=60).stdout.strip()
    t2 = time.perf_counter()
    print(f"peak sweep: card, power limit, SM clock, max SM clock, power draw before: {before}; "
          f"after: {after}; {launches} launches in {t2 - t1:.1f} s (card check {t1 - t0:.1f} s)")
    for line in peak.sweep_lines(results):
        print(f"peak sweep: {line}")
    if launches == 0:
        fail("the sweep launched no micro-kernel")
    best = {regime: peak.best(results, regime) for regime in ("filled", "smc")}
    top = max(best["filled"].values(), key=lambda r: r["warp_instr_per_s"])
    (B, S, L), plateau = FIT_SHAPE, {}
    for regime in best:
        mix, plateau[regime] = peak.smc_at_plateau(results, regime, B, S, L)
        print(f"peak: B1-B3 at the mix plateau of the {regime} regime "
              f"({mix['warp_instr_per_s'] / 1e9:.2f} G warp-instr/s) at B={B} S={S} L={L} M=16: "
              + ", ".join(f"{n} {v:.4f} ms" for n, v in plateau[regime].items()))
    # the plain version on the maximum's own work (its copies on a leading axis)
    args = (top["which"], top["streams"], top["unroll"])
    many = [x.expand(top["copies"], *x.shape) for x in (a, b, c)]
    peak.reference(*args, *many, inner=8)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    peak.reference(*args, *many)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    bound_ms, by = peak.bound_ms(*args, top["copies"])
    print(f"peak: maximum {top['warp_instr_per_s'] / 1e9:.2f} G warp-instr/s ({top['which']} "
          f"s={top['streams']}/u={top['unroll']}, {top['copies']} copies): {top['ms']:.4f} ms a "
          f"launch, {top['shares']['issue']:.3f} of the data-sheet issue ceiling; bound "
          f"{bound_ms:.4f} ms ({by}), plain version {plain_ms:.1f} ms")
    return dict(gates=gates, results=results, best=best, top=top, launches=launches,
                plain_ms=plain_ms, bound=(bound_ms, by), plateau=plateau, card=before)


def kernel_entry(name, source, replaces, launches, genome_launches, mesh_launches,
                 bench_launches, errs, gate, t, key):
    """One kernel of the JSON summary line; `key` names its times in `t`.
    `launches` counts phase 4 / 4b's fit of its path, `genome_launches`
    phase 7's fit from genome files, `mesh_launches` phase 8a's meshed fit,
    `bench_launches` phase 9's bench over its timed windows."""
    ms_bound, by = t[key + "_bound"]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "launches_by_path": {"psmcfa (phase 4/4b)": launches,
                                 "genome files (phase 7)": genome_launches,
                                 "mesh of one (phase 8a)": mesh_launches,
                                 "bench (phase 9)": bench_launches},
            **errs, "gate": gate, "ms": t[key],
            "plain_ms": t[key + "_plain"], "bound_ms": ms_bound, "bound_by": by,
            "library_ms": None}


def peak_entry(src: str, pk: dict) -> dict:
    """B6's kernel of the JSON summary: the micro-kernel maximum's launch
    (the card filled) with its plain time and bound, the card check's gate
    and errors, the sweep's launches (phase 10), and the best configuration
    of each micro-kernel in each regime."""
    top, gates = pk["top"], pk["gates"]
    keep = ("streams", "unroll", "copies", "threads", "warps", "ms", "warp_instr_per_s",
            "thread_ops_per_s", "shares")
    return {"name": "peak_micro_kernels", "route": "cuda", "source": src + "peak.cu",
            "replaces": "tools/vpu_peak.py:176", "launches": pk["launches"],
            "launches_by_path": {"sweep (phase 10)": pk["launches"]},
            "max_abs_err": max(g["max_abs_err"] for g in gates.values()),
            "max_rel_err": max(g["max_rel_err"] for g in gates.values()),
            "gate": "non-finite entries equal in position and sign; finite within rtol 1e-4 "
                    "(mix) or 1e-5 (fma, roll, multiport); copies bitwise equal",
            "errors_by_kernel": gates, "ms": top["ms"], "plain_ms": pk["plain_ms"],
            "bound_ms": pk["bound"][0], "bound_by": pk["bound"][1], "library_ms": None,
            "configuration": {k: top[k] for k in ("which", "streams", "unroll", "copies",
                                                   "threads")},
            "best": {regime: {w: {k: r[k] for k in keep} for w, r in kinds.items()}
                     for regime, kinds in pk["best"].items()},
            "smc_ms_at_mix_plateau": pk["plateau"], "card": pk["card"]}


def ptxas_report(log: str) -> dict:
    """(registers, spill-store bytes) of each kernel instance in a ptxas
    log, by kernel<template arguments> (numbers, or float / double)."""
    import re

    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?_kernel)I((?:Li\d+E|[fd])+)E", line)
        if m:
            args = [n or {"f": "float", "d": "double"}[t]
                    for n, t in re.findall(r"Li(\d+)E|([fd])", m.group(2))]
            name, spill = f"{m.group(1)}<{', '.join(args)}>", 0
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name] = (int(m.group(1)), spill)
            name = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="profile 5 SVGD steps of each path")
    args = ap.parse_args()
    t_start = time.perf_counter()
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
    from phlash_tpu_torch.ops import assembly, build, packed, smc

    lib = build.load_library()
    print(f"build: {lib.path.name} in {lib.build_seconds:.1f} s")
    for line in lib.ptxas_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    for name, (regs, spill) in ptxas_report(lib.ptxas_log).items():
        print(f"ptxas: {name}: {regs} registers, {spill} bytes spill stores")
    period = lib.lib.phlash_packed_period()
    print(f"packed kernels: checkpoint period {period} sites, "
          f"states a lane: forward {lib.lib.phlash_packed_states_per_lane(0)}, "
          f"adjoint {lib.lib.phlash_packed_states_per_lane(1)}")
    if period != packed.DEFAULT_SEG:
        fail(f"the library's checkpoint period {period} is not ops/packed.DEFAULT_SEG "
             f"({packed.DEFAULT_SEG})")

    # 3. kernels against their plain versions
    errs = check_kernels(torch, smc, dev)
    perrs = check_packed_kernels(torch, packed, dev)
    # 3c. the assembly kernels
    aerrs = check_assembly(torch, dev)

    # 4. the slice, once per hand-kernel backend, by graph replays
    ops = {"smc": smc, "packed": packed, "assembly": assembly}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke-") as tmp:
        path = Path(tmp) / "smoke.psmcfa"
        write_psmcfa(path)
        (counts, smc_models), (pcounts, packed_models) = (run_slice(torch, ops, dev, path, b, ov)
                                                          for b, ov in PATHS)
        built = {b: build_program(torch, dev, path, b, ov) for b, ov in PATHS}
        fit_inputs = {"initial cloud": packed_fit_inputs(torch, *built["packed"][:2], dev)}
        smc_inputs = {f"initial cloud, {k}": v
                      for k, v in smc_fit_inputs(torch, *built["smc"][:2], dev).items()}
        # 4c. eager and graphed steps in turns
        step_ms = step_timing(torch, {b: prog for b, (prog, _, _) in built.items()}, args.profile)
        # 4d. graphed against eager: both paths, and the dense backend small
        for i, (b, (prog, _, elpd)) in enumerate(built.items()):
            graphed_vs_eager(torch, prog, elpd, b, SEED + 10 + i)
        dense, _, dense_elpd = build_program(torch, dev, path, "dense", 50, num_particles=16,
                                             minibatch_size=2, chunk_size=200, niter=2)
        graphed_vs_eager(torch, dense, dense_elpd, "dense (16 particles, S=2, chunk 200 + 50)",
                         SEED + 12)
        # 4e. checkpoint/resume
        resume_check(torch, path, tmp, smc_models)
        packed_late = {"after the timed steps": packed_fit_inputs(torch, *built["packed"][:2],
                                                                  dev)}
        fit_inputs.update(packed_late)
        late = {f"after the timed steps, {k}": v
                for k, v in smc_fit_inputs(torch, *built["smc"][:2], dev).items()}

    # 3 and 3b, continued: each pair on its fit's late inputs
    check_fit_inputs(torch, smc, dev, late, errs)
    check_packed_fit_inputs(torch, packed, dev, packed_late, perrs)

    # 5. kernel times at the fit shape
    t = kernel_timing(torch, smc, dev, {**smc_inputs, **late})
    pt = packed_timing(torch, packed, dev, fit_inputs)
    at = assembly_timing(torch, dev, built["smc"][0])
    # 5c. the scan backend against the smc kernels
    check_scan(torch, dev)

    # 6. posterior reproduction against phlash_tpu.fit
    repro_phase(torch, ops)

    # 7. from genome files to a posterior
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke-") as tmp:
        gcounts = genome_phase(torch, ops, dev, tmp)

    # 8. the meshed fit, simulate_hmm and the profiler block
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke-") as tmp:
        mcounts = mesh_phase(torch, ops, dev, tmp, {"smc": smc_models, "packed": packed_models},
                             {b: prog for b, (prog, _, _) in built.items()})
        sim_phase(torch, dev, tmp)
        trace_phase(torch, built["smc"][0], dev, tmp)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()

    # 9. the port's bench, in its own process
    torch.cuda.empty_cache()
    blaunch = bench_phase(smi.stdout.splitlines()[0].split(",")[0].strip())

    # 10. the issue-rate micro-kernels (B6): the card check and the sweep
    pk = peak_phase(torch, dev, lib)

    if "jax" in sys.modules or "phlash_tpu" in sys.modules:
        fail("JAX or phlash_tpu was imported")
    print(f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s before its summary")
    print("svgd_step_ms_per_iter: " + " ".join(f"{b} {mode} {v:.3f}"
                                                for (b, mode), v in step_ms.items()))
    src = "phlash_tpu_torch/csrc/"
    smc_fwd = {"max_abs_err": errs["forward"]["abs"], "max_rel_err_ll": errs["forward"]["ll"],
               "max_rel_err_alpha_pstates": errs["forward"]["state"]}
    smc_gate = "rel: ll 1e-5, alpha and pstates 1e-4; B1 equal to B2 bitwise"
    sc, pc, gc = counts["smc"], pcounts["packed"], gcounts["smc"]
    msc, mpc = mcounts["smc"]["smc"], mcounts["packed"]["packed"]
    asm = {b: (c["assembly"], mcounts[b]["assembly"]) for b, c in (("smc", counts),
                                                                   ("packed", pcounts))}
    asm_gate = ("float64: values rtol 1e-10 (pi against max pi), gradient 1e-8 of max|plain|; "
                "float32, edge particles and the rest apart: finite, against plain float64 "
                "within max(2x plain float32's error, 4 ulps), leaves 1e-4 rel, pi 1e-6 abs; "
                "the edge particles' gradient within 1e-4 of max|plain float64|; every float32 "
                f"gradient within {ULP_GATE:g} of the plain float32 gradient's one-ulp spreads "
                "of it, coordinate by coordinate, also on tools/torch_assembly_edges.py's draw")
    asm_errs = {"max_abs_err": aerrs["max_abs_fwd"], "max_rel_err_f64": aerrs["f64_values"],
                "max_err_f32_leaves": aerrs["f32_leaves"],
                "max_f32_err_over_gate": aerrs["f32_over_plain"]}
    asm_grad_errs = {"max_abs_err": aerrs["max_abs_grad"],
                     "max_normalized_err_f64": aerrs["f64_grad"],
                     "max_normalized_err_f32": aerrs["f32_grad"],
                     "max_f32_err_over_gate": aerrs["f32_over_plain"],
                     "max_normalized_err_f32_edge": aerrs["f32_edge_grad"],
                     "max_f32_one_ulp_spreads": aerrs["f32_ulp_ratio"],
                     "max_f32_one_ulp_spreads_edges_draw": aerrs["f32_ulp_ratio_edges_draw"],
                     "max_f32_one_ulp_spreads_against_f64": aerrs["f32_ulp_ratio_f64"]}
    replaces = "phlash_tpu/mcmc.py:259"  # the jitted step whose assembly XLA fuses
    print(json.dumps({"kernels": [
        kernel_entry("smc_forward", src + "smc_forward.cu", "phlash_tpu/ops/pallas_smc.py:358",
                     sc["forward_cuda"] - sc["forward_cuda_residuals"],
                     gc["forward_cuda"] - gc["forward_cuda_residuals"],
                     msc["forward_cuda"] - msc["forward_cuda_residuals"],
                     blaunch.get("B1", 0), smc_fwd, smc_gate, t, "fwd"),
        kernel_entry("smc_forward_residuals", src + "smc_forward.cu",
                     "phlash_tpu/ops/pallas_smc.py:358", sc["forward_cuda_residuals"],
                     gc["forward_cuda_residuals"], msc["forward_cuda_residuals"],
                     blaunch.get("B2", 0), smc_fwd, smc_gate, t, "fwd_res"),
        kernel_entry("smc_backward", src + "smc_backward.cu", "phlash_tpu/ops/pallas_smc.py:511",
                     sc["backward_cuda"], gc["backward_cuda"], msc["backward_cuda"],
                     blaunch.get("B3", 0),
                     {"max_abs_err": errs["backward"]["abs"],
                      "max_normalized_err": errs["backward"]["grad"]},
                     "max|err| / max|plain| per gradient 2e-5", t, "bwd"),
        kernel_entry("packed_forward", src + "packed_forward.cu",
                     "phlash_tpu/ops/pallas_hmm.py:162", pc["forward_cuda"], 0,
                     mpc["forward_cuda"], blaunch.get("B4", 0),
                     {"max_abs_err": perrs["forward"]["abs"],
                      "max_rel_err_ll": perrs["forward"]["ll"],
                      "max_rel_err_ckpt": perrs["forward"]["ckpt"]},
                     "rel: ll 1e-5, ckpt 1e-4", pt, "fwd"),
        kernel_entry("packed_backward", src + "packed_backward.cu",
                     "phlash_tpu/ops/pallas_hmm_vjp.py:155", pc["backward_cuda"], 0,
                     mpc["backward_cuda"], blaunch.get("B5", 0),
                     {"max_abs_err": perrs["backward"]["abs"],
                      "max_normalized_err": perrs["backward"]["grad"]},
                     "max|err| / max|plain| per gradient 2e-5", pt, "bwd"),
        {**kernel_entry("assembly_forward", src + "assembly.cu", replaces,
                        asm["smc"][0]["forward_cuda"], gcounts["assembly"]["forward_cuda"],
                        asm["smc"][1]["forward_cuda"], blaunch.get("A1", 0), asm_errs,
                        asm_gate, at, "a1"),
         "launches_packed_path": asm["packed"][0]["forward_cuda"],
         "launch_floor_ms": at["launch_floor"], "launch_floor_graph_ms": at["launch_floor_graph"],
         "ms_eager": at["a1_eager"], "ms_n_minus_1_15": at["a1_n16"],
         "ms_eager_n_minus_1_15": at["a1_eager_n16"],
         "shape": at["shape"], "geometry": at["geometry"]["A1"],
         "design": "a warp a particle, lanes on the intervals; the 2M - 1 sub-interval "
                   "product, the prefix sums and the reductions as warp scans"},
        {**kernel_entry("assembly_backward", src + "assembly.cu", replaces,
                        asm["smc"][0]["backward_cuda"], gcounts["assembly"]["backward_cuda"],
                        asm["smc"][1]["backward_cuda"], blaunch.get("A2", 0), asm_grad_errs,
                        asm_gate, at, "a2"),
         "launches_packed_path": asm["packed"][0]["backward_cuda"],
         "launch_floor_ms": at["launch_floor"], "launch_floor_graph_ms": at["launch_floor_graph"],
         "ms_eager": at["a2_eager"], "ms_n_minus_1_15": at["a2_n16"],
         "ms_eager_n_minus_1_15": at["a2_eager_n16"],
         "shape": at["shape"], "geometry": at["geometry"]["A2"],
         "design": "A1's forward, then one reverse pass: suffix scans for the occupancy and "
                   "the prefix sums, each interval's local adjoint on width-3 dual numbers"},
        peak_entry(src, pk),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
