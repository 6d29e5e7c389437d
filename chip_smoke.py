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
3d. the per-particle entries (kernel_base.py) through the hand kernels, on
   smc and packed, one particle at M = 16, L = 2000, float32, on 5 chunks:
   loglik(pp, i) and kern(pp, inds, grad=True) against loglik_batched and
   autograd at the same rows (rel 1e-6, whether bitwise printed) and, for
   PSMCParams and DemographicModel pp, against their plain float64 version
   on the card (ll rtol 1e-5, gradients 2e-5 of max|plain|; a
   DemographicModel's time-grid gradient within twice the plain float32
   version's error + 2e-5); model.log_density against log_density_batched's row under a
   gradient (rel 1e-6); exactly one forward and one adjoint launch for the
   vector index, one forward for loglik, and the density's launches; the
   (B, S) = (1, 5) geometry and kernel times beside the launch floor;
4. the slice: phlash_tpu_torch.psmc on a seeded .psmcfa at 500 particles,
   S=5, chunks of 2000 + 500 overlap, 30 iterations (kernel_backend "smc"),
   by the default CUDA graph replays of steps_per_call = 10 iterations with
   the held-out ELPD fused into each call; the launch counters (which count
   replays) must show exactly the expected launches of the SMC' CUDA
   kernels, of A1 / A2 and of S1-S3 (expected_counts: every iteration one
   of each, every ELPD one A1) and nothing else;
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
11. the whole genome: `python tools/torch_genome_scale_demo.py --holdout` at
   scale 1.0 in its own process (22 synthesized chromosomes, chr22 held
   out, ~47,000 resident chunks of 600 columns, 500 particles, 30
   iterations by graph replay, then 3 runs of 5 timed replays, the ELPD's
   overhead), its stage lines echoed with the card's name and power limit;
   it fails unless the chunk count is the sum over the chromosomes of
   chunk_het_matrix's rows from their lengths, B2, B3, A1 and A2 launched
   exactly what 30 iterations, one capture and the timed replays imply and
   B1 what the ELPDs imply, packed launched nothing, and the cloud is finite.
12. posterior recovery against the truth: B1-B3 against their plain
   versions at the validation fit's chunk length (L = 100,000, B = 500,
   S = 5; phase 3's tolerances), then `python tools/torch_validate.py
   --n-samples n` at full size (constant, bottleneck and zigzag; three
   contigs of 500,000 windows from the continuous SMC' simulator, one held
   out; 500 particles, up to 300 iterations with ELPD early stopping,
   tools/validate.py's options and seeds) in its own process for n = 1 and
   2, its lines echoed with the card's name and power limit; it fails
   unless the tool exits 0 (worst tv < 0.25), every tv and coverage is
   finite, and each fit launched exactly the smc kernels and A1 / A2 that
   the iterations it ran imply (nothing packed, nothing plain); coverage
   and each posterior's tv against the other two truths are printed, not
   gated.
13. the step's ablation profile: B2 + B3 at L = 64 against their plain
   versions (the -sites row's length, below one observation tile), then
   `python tools/torch_step_profile.py` at its defaults in its own process
   (full, -afs, -warmup, -sites, svgd-only, the kernels alone, the
   assembly alone; graphed and eager ms); it fails unless every row is
   there, finite and positive, and launched exactly its variant's B2 + B3
   and A1 + A2 for the iterations it ran and nothing else.
14. the walkthrough: B1-B3 against their plain versions at the shapes
   of docs/torch_example.py's fit, read from the fit's own chunking of the
   script's data (B = 32 particles, S = 1 training chunk of 5,000 + 100,
   the ELPD's S = 4; phase 3's tolerances), then `python
   docs/torch_example.py` at its full size in its own process (BCF ->
   contig -> fit with mesh, checkpoint, steps_per_call = 5 and held-out
   data -> plot -> confidence band), its lines echoed; it fails unless the
   script exits 0 with DONE on phase 1's card, its checkpoint holds the
   cloud, the band is ordered, and the fit launched exactly the smc
   kernels and A1 / A2 that its iterations, calls of 5 and ELPDs imply and
   nothing else.
15. the SVGD update's kernels (S1 distances, S2 bandwidth, S3 direction and
   amsgrad; ops/svgd.py): right after phase 3d, against their plain
   versions on the card (check_svgd) at P = 500, 48, 37, 32, 8, 3 and 2,
   D = 18 and 40, float32 and float64, random, tied, lattice and
   degenerate clouds with inf and NaN gradient rows, all rows and a mesh
   block, from a mid-fit amsgrad state: h bitwise the sort's, the state
   within 1e-6 / 1e-12 of max|plain float64|, the count exact; every fit
   above (phases 4-14) launches S1, S2 and S3 exactly once an iteration and
   no plain SVGD call.  At the end, their times on the smc fit's cloud
   against the plain pieces, torch.sort (S2's library call) and their
   bounds, and the ablation rows full and svgd-only by graph replay with
   the update through S1-S3 and through its plain version, in turns.
`--profile` also prints torch.profiler tables of eager and graphed steps
of each path, with the device busy share.
The last two lines are a JSON summary of the kernels (B1-B6, A1, A2,
S1-S3) and the result line.
It exits non-zero, printing no result, without a CUDA device or when the
package is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import logging
import math
import os
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


def gate_smc(torch, smc, params, pi, obs, gbar, abar0, where, errs, f32_floor=False):
    """The forward (B2, with residuals) and adjoint (B3) kernels against
    their plain versions in float64 on the card; B1 (no residuals) must give
    B2's ll and alpha;
    the plain forward itself must agree with the per-site scan oracle
    (hmm.psmc_ll).  Inputs float64; folds the errors into `errs` (as
    check_kernels returns them) and returns the smallest positive
    period-state entry.  With f32_floor (short rows, whose |ll| can be
    ~0.1, where float32's rounding alone exceeds 1e-5 relative) an
    instance's ll may also sit within twice the plain float32 forward's
    error on that instance, as phase 3c's float32 rule reads."""
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
    ll_ok = e_ll <= 1e-5
    if f32_floor:
        ll_32 = smc.forward_structured(p32, pi32, obs, False)[0].double()
        err, floor = (ll_k.double() - ll_p).abs(), 2.0 * (ll_32 - ll_p).abs()
        rule = float((err / torch.maximum(1e-5 * ll_p.abs(), floor)).max())
        print(f"{where}: plain float32 forward's max rel err ll {max_rel(ll_32, ll_p):.3e}; the "
              f"kernel's ll error over max(1e-5 |ll|, 2x the plain float32 error), at most "
              f"{rule:.3f}")
        ll_ok, errs["ll_over_rule"] = rule <= 1.0, max(errs.get("ll_over_rule", 0.0), rule)
    worst = 0.0
    for name, a, b in zip(names, (*g_k, dpi_k), (*g_p, dpi_p)):
        norm = normalized(a, b)
        worst = max(worst, norm)
        bwd["abs"] = max(bwd["abs"], max_abs(a, b))
        if not norm <= 2e-5:
            fail(f"adjoint kernel disagrees on d{name} at {where}: normalized err {norm:.3e}")
    print(f"{where}: max rel err ll {e_ll:.3e} alpha {e_a:.3e} pstates {e_ps:.3e}; "
          f"max normalized err over the 7 gradients {worst:.3e}")
    if not (ll_ok and e_a <= 1e-4 and e_ps <= 1e-4):
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


# Phase 3d: the per-particle entries (kernel_base.py) at the fit's widths:
# one particle on PP_INDS (n = 5) of PP_CHUNKS rows of L = 2000 windows
# (warm-up prefixes of 500 for the smc density), M = 16, float32.
PP_CHUNKS, PP_L, PP_OVERLAP = 8, 2000, 500
PP_INDS, PP_INDEX = (0, 3, 5, 6, 7), 3


@contextlib.contextmanager
def plain_on_card(mod, forward, backward, device_type: str, dtype=None):
    """`mod`'s dispatch routed to its plain versions, with the kernel dtype
    for `device_type` set to `dtype` (None: none): inside, the per-particle
    entries run their plain version on the card, in `dtype` (None: the
    parameters' dtype)."""
    from phlash_tpu_torch.ops import build

    saved = mod.forward, mod.backward, build.KERNEL_DTYPE.pop(device_type)
    mod.forward, mod.backward = forward, backward
    if dtype is not None:
        build.KERNEL_DTYPE[device_type] = dtype
    try:
        yield
    finally:
        mod.forward, mod.backward = saved[:2]
        build.KERNEL_DTYPE[device_type] = saved[2]


def one_particle_counts(mod, fn) -> dict:
    "`fn()`'s launches, by `mod`'s counters."
    mod.reset_counts()
    fn()
    return mod.counts()


def per_particle_phase(torch, dev) -> dict:
    """Phase 3d: the per-particle entries on the card through the hand
    kernels, on smc and packed: loglik(pp, i) and kern(pp, inds, grad=True)
    (n = 5) against loglik_batched / autograd at the same rows (rel 1e-6,
    whether bitwise printed) and, for PSMCParams and DemographicModel pp,
    against the entries' plain float64 version on the card (ll rtol 1e-5,
    gradients 2e-5 of max|plain| a leaf; a DemographicModel's t within 2x
    the plain float32 version's error + 2e-5); model.log_density against
    log_density_batched's row under a gradient; exactly one forward and one
    adjoint launch for the vector index (one forward for loglik), and the
    density's launches, and no SVGD update's (ops/svgd.py); the B = 1 launch
    geometry and times beside the launch floor and roofline.py's bounds.
    Returns each module's launches in the phase and the times."""
    import numpy as np

    from phlash_tpu_torch import roofline
    from phlash_tpu_torch.kernel_base import one_particle
    from phlash_tpu_torch.model import log_density, log_density_batched
    from phlash_tpu_torch.ops import assembly, packed, smc
    from phlash_tpu_torch.ops import svgd as ops_svgd
    from phlash_tpu_torch.ops.kernel_packed import PackedKernel
    from phlash_tpu_torch.ops.kernel_smc import SMCKernel
    from phlash_tpu_torch.params import PSMC_FIELDS, MCMCParams, PSMCParams
    from phlash_tpu_torch.utils import Pattern

    M, n = 16, len(PP_INDS)
    rng = np.random.default_rng(SEED + 30)
    chunks = (rng.random((PP_CHUNKS, PP_OVERLAP + PP_L)) < 0.05).astype(np.int8)
    chunks[2, 900:1100] = -1
    warm_all = torch.as_tensor(chunks[:, :PP_OVERLAP], device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    pat = PATTERNS[M]
    base = MCMCParams.from_linear(pattern=pat, t1=1e-4, tM=15.0, c=[1.0] * len(Pattern(pat)),
                                  theta=1e-2, rho=1e-2, device=dev)
    flat = base.flatten() + 0.3 * torch.randn(3, base.flatten().shape[-1], generator=gen,
                                              device=dev, dtype=torch.float64)
    cloud64 = base.unflatten(flat)  # three particles; the first is the one
    one64 = base.unflatten(flat[0])
    dm64 = one64.to_dm()
    pp64 = PSMCParams.from_dm(dm64)
    pp32 = pp64.to(torch.float32)
    idx = torch.tensor(PP_INDS, device=dev)
    j = PP_INDS.index(PP_INDEX)
    out = {"launches": {"smc": {}, "packed": {}, "assembly": {}}, "ms": {}}
    ops_svgd.reset_counts()  # the entries run no SVGD update: read at the end

    def leaves_of(pp):
        return [getattr(pp, k).detach().clone().requires_grad_(True) for k in PSMC_FIELDS]

    paths = (("smc", SMCKernel, smc, smc.forward_structured, smc.backward_structured),
             ("packed", PackedKernel, packed, packed.forward_packed, packed.backward_packed))
    for name, cls, mod, fwd_plain, bwd_plain in paths:
        kern = cls(M, chunks[:, PP_OVERLAP:], device=dev)
        lanes = mod.kernel_geometry(1, n, M) if name == "smc" else mod.kernel_geometry(1, n)
        print(f"per-particle {name}: (B, S) = (1, {n}) launch geometry {lanes}")
        c_scalar = one_particle_counts(mod, lambda: kern.loglik(pp32, PP_INDEX))
        c_vec = one_particle_counts(mod, lambda: kern(pp32, idx, grad=True))
        c_dm = one_particle_counts(mod, lambda: kern(dm64, idx, grad=True))
        want_vec = dict(forward_cuda=1, backward_cuda=1, forward_plain=0, backward_plain=0)
        want_scalar = dict(want_vec, backward_cuda=0)
        if name == "smc":
            want_vec["forward_cuda_residuals"], want_scalar["forward_cuda_residuals"] = 1, 0
        for what, got, want in (("loglik(pp, i)", c_scalar, want_scalar),
                                ("kern(pp, inds, grad=True)", c_vec, want_vec),
                                ("kern(dm, inds, grad=True)", c_dm, want_vec)):
            print(f"per-particle {name}: {what} launched {got}")
            check_counts(got, want, f"per-particle {name} {what}")
        for k, v in c_vec.items():
            out["launches"][name][k] = v + c_scalar[k] + c_dm[k]

        # against the batched entry and autograd at the same rows, float32
        ll_i = kern.loglik(pp32, PP_INDEX)
        ll, g = kern(pp32, idx, grad=True)
        ll_b = kern.loglik_batched(one_particle(pp32, n), idx)[0]
        auto = []
        for i in range(n):
            lv = leaves_of(pp32)
            ll_r = kern.loglik_batched(one_particle(PSMCParams(*lv), 1), idx[i:i + 1])[0, 0]
            auto.append(torch.autograd.grad(ll_r, lv))
        e_ll = max(max_rel(ll, ll_b), max_rel(ll_i, ll_b[j]))
        e_g = max(normalized(getattr(g, k)[i], auto[i][f]) for i in range(n)
                  for f, k in enumerate(PSMC_FIELDS))
        bitwise = (torch.equal(ll, ll_b) and torch.equal(ll_i, ll_b[j]),
                   all(torch.equal(getattr(g, k)[i], auto[i][f]) for i in range(n)
                       for f, k in enumerate(PSMC_FIELDS)))
        print(f"per-particle {name}: against loglik_batched / autograd at the same rows: "
              f"ll max rel err {e_ll:.3e} (bitwise {bitwise[0]}), gradients max normalized "
              f"err {e_g:.3e} (bitwise {bitwise[1]})")
        if not (e_ll <= 1e-6 and e_g <= 1e-6):
            fail(f"per-particle {name} entries disagree with the batched entry")

        # against their plain float64 version on the card
        ll_dm, g_dm = kern(dm64, idx, grad=True)
        with plain_on_card(mod, fwd_plain, bwd_plain, dev.type):
            ll_p, g_p = kern(pp64, idx, grad=True)
            ll_pi = kern.loglik(pp64, PP_INDEX)
            ll_pdm, g_pdm = kern(dm64, idx, grad=True)
        with plain_on_card(mod, fwd_plain, bwd_plain, dev.type, torch.float32):
            _, g_32dm = kern(dm64, idx, grad=True)
        if not (g_dm.eta.t.dtype == torch.float64 and g_p.b.dtype == torch.float64):
            fail(f"per-particle {name}: a float64 pp's gradients are not float64")
        e_ll = max(max_rel(ll, ll_p), max_rel(ll_i, ll_pi), max_rel(ll_dm, ll_pdm))
        e_g = max(normalized(getattr(g, k), getattr(g_p, k)) for k in PSMC_FIELDS)
        e_dm = max(normalized(a, b) for a, b in ((g_dm.eta.c, g_pdm.eta.c),
                                                 (g_dm.theta, g_pdm.theta),
                                                 (g_dm.rho, g_pdm.rho)))
        # the time grid's gradient through from_dm amplifies a float32
        # kernel's rounding by the transition's derivative (on smc the plain
        # float32 version itself sits ~7e-3 of max off float64): gated
        # against the plain float32 version's error in this run, by 3c's 2x rule
        e_t, e_t32 = normalized(g_dm.eta.t, g_pdm.eta.t), normalized(g_32dm.eta.t, g_pdm.eta.t)
        print(f"per-particle {name}: against the plain float64 version on the card: ll max rel "
              f"err {e_ll:.3e}; gradients max normalized err {e_g:.3e} (PSMCParams), "
              f"{e_dm:.3e} (DemographicModel: c, theta, rho), t {e_t:.3e} (gate 2 x the "
              f"plain float32 version's {e_t32:.3e} + 2e-5)")
        if not (e_ll <= 1e-5 and e_g <= 2e-5 and e_dm <= 2e-5 and e_t <= 2 * e_t32 + 2e-5):
            fail(f"per-particle {name} entries disagree with their plain version")

        # one particle's density against log_density_batched's row, under a gradient
        overlap = PP_OVERLAP if name == "smc" else 0
        kw = dict(c=(1.0, PP_CHUNKS / n, 1.0), inds=idx, warmup=warm_all[idx, :overlap],
                  kern=kern, afs=torch.tensor([5.0], device=dev))
        x1 = one64.flatten().float().requires_grad_(True)
        xb = cloud64.flatten().float().requires_grad_(True)
        mod.reset_counts()
        assembly.reset_counts()
        v1 = log_density(base.unflatten(x1), **kw)
        g1, = torch.autograd.grad(v1, x1)
        c_den = {"kernels": mod.counts(), "assembly": assembly.counts()}
        vb = log_density_batched(base.to(torch.float32).unflatten(xb), **kw)
        gb, = torch.autograd.grad(vb[0], xb)
        e_v, e_gd = max_rel(v1.detach(), vb[0].detach()), normalized(g1, gb[0])
        print(f"per-particle {name}: log_density (overlap {overlap}) {float(v1):.6f} against "
              f"log_density_batched's row: rel err {e_v:.3e} (bitwise {torch.equal(v1, vb[0])}), "
              f"gradient normalized err {e_gd:.3e} (bitwise {torch.equal(g1, gb[0])}); "
              f"launches {c_den}")
        if not (e_v <= 1e-6 and e_gd <= 1e-6):
            fail(f"per-particle {name}: log_density disagrees with log_density_batched")
        passes = 2 if name == "smc" else 1  # the warm-up filter and the likelihood
        want_k = dict(forward_cuda=passes, backward_cuda=passes, forward_plain=0,
                      backward_plain=0)
        if name == "smc":
            want_k["forward_cuda_residuals"] = passes
        check_counts(c_den["kernels"], want_k, f"per-particle {name} log_density")
        check_counts(c_den["assembly"], dict(forward_cuda=1, backward_cuda=1, forward_plain=0,
                                             backward_plain=0), f"per-particle {name} density")
        for k, v in c_den["kernels"].items():
            out["launches"][name][k] += v
        for k, v in c_den["assembly"].items():
            out["launches"]["assembly"][k] = out["launches"]["assembly"].get(k, 0) + v

        # times at B = 1: the entry eager, and its kernels by graph replay
        t = {"entry": time_ms(torch, lambda: kern(pp32, idx, grad=True), 20)}
        rows = kern.data[idx].contiguous()
        if name == "smc":
            params = tuple(getattr(pp32, k)[None].contiguous() for k in PSMC_FIELDS[:6])
            pi = pp32.pi[None, None].expand(1, n, -1).contiguous()
            ll0, _, ps = smc.forward_cuda(params, pi, rows, True)
            gbar, ab = torch.ones_like(ll0), torch.zeros_like(pi)
            t["B1"] = time_graph_ms(torch, lambda: smc.forward_cuda(params, pi, rows, False))
            t["B2"] = time_graph_ms(torch, lambda: smc.forward_cuda(params, pi, rows, True))
            t["B3"] = time_graph_ms(torch, lambda: smc.backward_cuda(params, rows, ps, gbar, ab))
        else:
            from phlash_tpu_torch.ops.packing import dense_transition

            A = dense_transition(pp32)[None].contiguous()
            e0, e1 = pp32.emis0[None].contiguous(), pp32.emis1[None].contiguous()
            pi = pp32.pi[None, None].expand(1, n, -1).contiguous()
            ll0, ck = packed.forward_packed_cuda(A, e0, e1, pi, rows, kern.seg_len, True)
            gbar = torch.ones_like(ll0)
            t["B4"] = time_graph_ms(torch, lambda: packed.forward_packed_cuda(
                A, e0, e1, pi, rows, kern.seg_len, True))
            t["B5"] = time_graph_ms(torch, lambda: packed.backward_packed_cuda(
                A, e0, e1, rows, ck, gbar, kern.seg_len))
        live = float((rows != -2).sum())
        kernels = ({"B1": "smc_forward", "B2": "smc_forward_residuals", "B3": "smc_backward"}
                   if name == "smc" else {"B4": "packed_forward_ckpt", "B5": "packed_backward"})
        for b, k in kernels.items():
            t[b + "_bound"] = roofline.kernel_bound(k, M, 1, n, rows.shape[1], live)[0]
        out["ms"][name] = t
    out["launches"]["svgd"] = ops_svgd.counts()
    check_counts(out["launches"]["svgd"], svgd_counts(0), "the per-particle entries' SVGD update")
    one = torch.zeros(1, device=dev)
    out["ms"]["launch_floor"] = time_ms(torch, lambda: one.add_(1.0), 20)
    out["ms"]["launch_floor_graph"] = time_graph_ms(torch, lambda: one.add_(1.0))
    geo = assembly.kernel_geometry(M, 1, 1, torch.float32, True)
    print(f"per-particle times at (B, S, L) = (1, {n}, {PP_L}), M = {M}, float32: "
          + "; ".join(f"{b}: " + ", ".join(f"{k} {v:.4g} ms" for k, v in out["ms"][b].items())
                      for b in ("smc", "packed"))
          + f" (kernels by graph replay, the entry kern(pp, inds, grad=True) eager); launch "
          f"floor (a one-element add) {out['ms']['launch_floor']:.4f} ms eager, "
          f"{out['ms']['launch_floor_graph']:.4f} ms by graph replay; A1 / A2 at P = 1: one "
          f"warp in one block of {geo['warps_per_block']}")
    return out


# Phase 15: the SVGD update's kernels (S1-S3, ops/svgd.py) against their plain
# versions.  The clouds: the fit's P = 500 and the walkthrough's 32, phase 6's
# 48, phase 4's tests' 8, an odd 37 and the two least (P (P - 1) / 2 odd at 3);
# D = 18 (pattern 14*1+1*2) and 40 (more coordinates than a warp's lanes).
SVGD_PS = (500, 48, 37, 32, 8, 3, 2)
SVGD_DS = (18, 40)
SVGD_KINDS = ("random", "ties", "lattice", "degenerate")
SVGD_COUNT = 7  # the amsgrad count of the gated state: a mid-fit state
SVGD_RTOL = {"float32": 1e-6, "float64": 1e-12}  # state, against max|plain float64|
SVGD_REPEATS = 256  # S2's launches in a row on one triangle (check_svgd's determinism check)


def svgd_case(torch, kind: str, P: int, D: int, gen, dev):
    """(particles, gradients) float64 (P, D) of a gated case.  random: N(0, 1);
    ties: every particle twice (zero distances, a median above 0); lattice:
    coordinates on a grid of 1/2, so many distances are equal; degenerate:
    P copies of one particle (every distance 0, so h is the 1e-12 floor).
    The gradients are N(0, 1) with a row of +inf and (P >= 3) a row of NaN
    and -inf, which the update zeroes."""
    x = torch.randn(P, D, generator=gen, device=dev, dtype=torch.float64)
    if kind == "ties":
        x = x[torch.arange(P, device=dev) // 2]
    elif kind == "lattice":
        x = torch.round(2 * x) / 2
    elif kind == "degenerate":
        x = x[:1].expand(P, D).contiguous()
    g = torch.randn(P, D, generator=gen, device=dev, dtype=torch.float64)
    g[P - 1] = math.inf
    if P >= 3:
        g[0, ::2], g[0, 1::2] = math.nan, -math.inf
    return x, g


def svgd_state(torch, phi, gen, dtype, optimizer):
    """A mid-fit amsgrad state of `phi`'s block at SVGD_COUNT steps, at the
    scale s of the direction: mu ~ s N(0, 1) / 2, nu ~ s^2 U(1/2, 3/2),
    nu_max = nu / (1 - b2^count) (1 + U(0, 1))."""
    from phlash_tpu_torch.svgd import AMSGradState

    s = float(phi.abs().max()) or 1.0
    dev = phi.device
    u = lambda: torch.rand(phi.shape, generator=gen, device=dev, dtype=torch.float64)  # noqa
    mu = 0.5 * s * torch.randn(phi.shape, generator=gen, device=dev, dtype=torch.float64)
    nu = s * s * (0.5 + u())
    nu_max = nu / (1 - optimizer.b2 ** SVGD_COUNT) * (1 + u())
    count = torch.full((), SVGD_COUNT, dtype=torch.int64, device=dev)
    return AMSGradState(*(t.to(dtype).contiguous() for t in (mu, nu, nu_max)), count)


def svgd_first_digit(torch, tri) -> list:
    """[prefix, rank, count] of the exact selection after its first digit,
    the top ops/svgd.RADIX bits of the triangle's float bit patterns: the
    lower middle element's digit, its rank among the elements that share
    that digit, and how many do (S1's `sel`)."""
    from phlash_tpu_torch.ops.svgd import RADIX

    itype, nbits = (torch.int32, 32) if tri.dtype == torch.float32 else (torch.int64, 64)
    key = tri.contiguous().view(itype) >> (nbits - RADIX)
    k_lo = (tri.numel() - 1) // 2
    prefix = torch.sort(key).values[k_lo]
    return [int(prefix), k_lo - int((key < prefix).sum()), int((key == prefix).sum())]


def tri_matrix(torch, tri, P: int):
    "The symmetric (P, P) matrix, zero diagonal, of a row-major strict lower triangle."
    i, j = torch.tril_indices(P, P, -1, device=tri.device)
    full = torch.zeros(P, P, dtype=tri.dtype, device=tri.device)
    full[i, j] = tri
    full[j, i] = tri
    return full


def svgd_repeats(torch, k, dev, gen, P: int, D: int) -> int:
    """S2 SVGD_REPEATS times in a row on one triangle of a random (P, D)
    cloud in each dtype, and on the card S1 + S2 SVGD_REPEATS / 4 times on
    each of two side streams, launched in turns with neither waiting for the
    other: fails unless every h, triangle and selection state is bitwise the
    first's (each launch sums its histogram in a workspace of its own, and
    the selection is exact).  Returns the launches compared."""
    n = 0
    for dtype in (torch.float32, torch.float64):
        x, g = (t.to(dtype) for t in svgd_case(torch, "random", P, D, gen, dev))
        tri, _, _, sel = k.distances_cuda(x, g)
        h0 = k.bandwidth_cuda(tri, sel, P)
        hs = [k.bandwidth_cuda(tri, sel, P) for _ in range(SVGD_REPEATS)]
        outs = []
        if dev.type == "cuda":
            here = torch.cuda.current_stream(dev)
            side = [torch.cuda.Stream(dev) for _ in range(2)]
            for s in side:
                s.wait_stream(here)
            for _ in range(SVGD_REPEATS // 4):
                for s in side:
                    with torch.cuda.stream(s):
                        t2, _, _, s2 = k.distances_cuda(x, g)
                        outs.append((t2, s2, k.bandwidth_cuda(t2, s2, P)))
            for s in side:
                here.wait_stream(s)
        bad = sum(not torch.equal(h, h0) for h in hs) + sum(
            not (torch.equal(t2, tri) and torch.equal(s2, sel) and torch.equal(h, h0))
            for t2, s2, h in outs)
        if bad:
            fail(f"svgd S1/S2 P={P} D={D} {dtype}: {bad} of {len(hs) + len(outs)} repeated "
                 f"launches differ from the first bitwise")
        n += len(hs) + 2 * len(outs)
    return n


def check_svgd(torch, dev, kernels=None, ps=SVGD_PS, ds=SVGD_DS) -> dict:
    """Phase 15's gate: S1-S3 against their plain versions on the card at
    every P of SVGD_PS, D of SVGD_DS and kind of SVGD_KINDS, all rows and a
    mesh block, in float32 and float64, from a mid-fit amsgrad state:
      S1's x^T and masked g^T bitwise x's transpose and the plain mask's,
        its selection state the first digit's (svgd_first_digit), its
        triangle within 2 (D + 2) units of roundoff u of the dtype of the
        plain float64 squared distances of the same (rounded) inputs,
        elementwise (a difference and a D-term sum rounded, in the kernel's
        sum and, in float64, in the plain one);
      S2's h bitwise median_bandwidth's (the sort) and offdiag_median_select's
        on S1's triangle in the same dtype, on the card;
      S3's particles, mu, nu and nu_max within SVGD_RTOL of max|plain| of the
        plain float64 update of the same inputs; for the degenerate cloud the
        plain float64 amsgrad of its exact direction, the mean masked
        gradient (the plain version's K x - rowsum(K) x_r cancels there, and
        2 / h = 2e12 scales its rounding); the count exact;
      S1 and S2 deterministic: svgd_repeats at the first P and D.
    Prints h against the plain version's own float32 / float64 h (from
    torch's distances) beside it, and as a control the plain float32 update
    (svgd.update_plain) on the same gate as S3's float32 state.  `kernels` (default ops/svgd.py), `ps` and
    `ds` let a CPU test rehearse the gate with stand-ins at fewer sizes.
    Returns the largest errors."""
    from phlash_tpu_torch import svgd
    from phlash_tpu_torch.ops import svgd as ops_svgd

    k = kernels or ops_svgd
    opt = svgd.AMSGrad(learning_rate=0.1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    errs = {"tri": 0.0, "state": {"float32": 0.0, "float64": 0.0}, "h_vs_plain_own": 0.0,
            "abs": {"tri": 0.0, "h": 0.0, "state": 0.0},
            "plain_f32": {"clouds": 0.0, "degenerate": 0.0}}
    cases = h_same_plain = 0
    t0 = time.perf_counter()
    for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        u = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -53
        for P in ps:
            for D in ds:
                for kind in SVGD_KINDS:
                    x64, g64 = svgd_case(torch, kind, P, D, gen, dev)
                    x, g = x64.to(dtype), g64.to(dtype)
                    xr, gr = x.double(), g.double()  # the rounded inputs, in float64
                    where = f"{kind} P={P} D={D} {dname}"
                    tri, xt, gt, sel = k.distances_cuda(x, g)
                    if not torch.equal(xt, x.t()):
                        fail(f"svgd S1 {where}: x^T is not the particles transposed")
                    if sel.tolist() != svgd_first_digit(torch, tri):
                        fail(f"svgd S1 {where}: the selection's first digit {sel.tolist()} is "
                             f"not {svgd_first_digit(torch, tri)}")
                    h = k.bandwidth_cuda(tri, sel, P)
                    masked = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                    if not torch.equal(gt, masked.t()):
                        fail(f"svgd S1 {where}: the masked g^T is not the plain mask's transpose")
                    i, j = torch.tril_indices(P, P, -1, device=dev)
                    want_tri = ((xr[i] - xr[j]) ** 2).sum(-1)
                    err, bound = (tri.double() - want_tri).abs(), 2 * (D + 2) * u * want_tri
                    if not bool((err <= bound).all()):
                        fail(f"svgd S1 {where}: squared distances off the plain float64 ones "
                             f"by more than 2 (D + 2) units of roundoff")
                    errs["tri"] = max(errs["tri"], float((err / bound.clamp_min(1e-300)).max()))
                    errs["abs"]["tri"] = max(errs["abs"]["tri"], float(err.max()))
                    full = tri_matrix(torch, tri, P)
                    h_sort = svgd.median_bandwidth(full, P)
                    med = svgd.offdiag_median_select(torch.sqrt(full), P)
                    h_sel = torch.clamp_min(med**2 / math.log(P), 1e-12)
                    if not (torch.equal(h, h_sort) and torch.equal(h, h_sel)):
                        fail(f"svgd S2 {where}: h {h.item()!r} is not the sort's {h_sort.item()!r} "
                             f"/ the selection's {h_sel.item()!r} bitwise")
                    if kind == "degenerate" and h.item() != torch.tensor(1e-12, dtype=dtype).item():
                        fail(f"svgd S2 {where}: h {h.item()!r} is not the 1e-12 floor")
                    h_own = svgd.median_bandwidth(((x[:, None] - x[None]) ** 2).sum(-1), P)
                    h_same_plain += int(torch.equal(h, h_own))
                    errs["h_vs_plain_own"] = max(errs["h_vs_plain_own"], max_rel(h, h_own))
                    # all rows, and one mesh block (rows 125:250 of 500)
                    for rows in (slice(None), slice(P // 4, P // 2)):
                        if kind == "degenerate":
                            gmr = torch.where(torch.isfinite(gr), gr, torch.zeros_like(gr))
                            phi = (gmr.sum(0) / P).expand(P, D)[rows]
                        else:
                            phi = svgd.svgd_direction(
                                xr, torch.where(torch.isfinite(gr), gr, torch.zeros_like(gr)),
                                rows)
                        state = svgd_state(torch, phi, gen, dtype, opt)
                        state64 = svgd.AMSGradState(*(t.double() for t in
                                                      (state.mu, state.nu, state.nu_max)),
                                                    state.count)
                        upd, o = opt.update(-phi, state64)
                        want = (xr[rows] + upd, o.mu, o.nu, o.nu_max)
                        got = k.update_cuda(x, xt, gt, h, rows, state.mu, state.nu,
                                            state.nu_max, state.count, opt)
                        if not torch.equal(got[4], o.count):
                            fail(f"svgd S3 {where} rows {rows}: count {got[4]} != {o.count}")
                        e = max(normalized(a, b) for a, b in zip(got[:4], want))
                        errs["abs"]["state"] = max(errs["abs"]["state"], max(
                            max_abs(a, b) for a, b in zip(got[:4], want)))
                        errs["state"][dname] = max(errs["state"][dname], e)
                        if not e <= SVGD_RTOL[dname]:
                            fail(f"svgd S3 {where} rows {rows}: the state is off the plain "
                                 f"float64 update by {e:.3e} of max|plain| > {SVGD_RTOL[dname]}")
                        if dtype == torch.float32:  # the control, not gated
                            ctrl = svgd.update_plain(x, g, rows, state, opt)
                            e_ctrl = max(normalized(a, b) for a, b in zip(ctrl[:4], want))
                            c_key = "degenerate" if kind == "degenerate" else "clouds"
                            errs["plain_f32"][c_key] = max(errs["plain_f32"][c_key], e_ctrl)
                        cases += 1
    repeats = svgd_repeats(torch, k, dev, gen, ps[0], ds[0])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"svgd: S1-S3 against their plain versions in {cases} cases "
          f"({time.perf_counter() - t0:.1f} s): h bitwise the sort's and the selection's on "
          f"S1's triangle in every case; largest errors: triangle "
          f"{errs['tri']:.3f} of its 2 (D + 2) u bound, state (normalized) float32 "
          f"{errs['state']['float32']:.3e} (gate {SVGD_RTOL['float32']:g}), float64 "
          f"{errs['state']['float64']:.3e} (gate {SVGD_RTOL['float64']:g}); the plain float32 "
          f"update (control, not gated) on the float32 gate: {errs['plain_f32']['clouds']:.3e} "
          f"(random, ties, lattice), {errs['plain_f32']['degenerate']:.3e} (degenerate); "
          f"{repeats} repeated S1 / S2 launches bitwise the first (S2 {SVGD_REPEATS} in a row a "
          f"dtype, S1 + S2 on two side streams at once); h bitwise the "
          f"plain version's own (torch's distances) in {h_same_plain} of "
          f"{len(ps) * len(ds) * len(SVGD_KINDS) * 2}, largest rel diff "
          f"{errs['h_vs_plain_own']:.3e} (not gated)")
    return dict(errs, cases=cases, repeats=repeats)


@contextlib.contextmanager
def svgd_plain_on_card():
    """ops/svgd.step_cuda routed to the plain update (svgd.update_plain) on
    the card's tensors, as plain_on_card routes the HMM kernels: inside,
    SVGD.step runs the plain version on the card."""
    from phlash_tpu_torch import svgd
    from phlash_tpu_torch.ops import svgd as ops_svgd

    saved = ops_svgd.step_cuda
    ops_svgd.step_cuda = svgd.update_plain
    try:
        yield
    finally:
        ops_svgd.step_cuda = saved


def time_caller(torch, base_step, state, gen, n_chunks: int, S: int, calls: int = 3,
                k: int = 10) -> tuple[float, int]:
    """(ms an iteration, iterations run) of `base_step` by graph replay
    (training.Caller): the best of `calls` calls of k iterations (the CUDA
    default steps_per_call) after the one that captures, as
    tools/torch_step_profile.py times its rows."""
    from phlash_tpu_torch.training import Caller

    call = Caller(base_step)
    inds = torch.randint(n_chunks, (calls + 1, k, S), generator=gen, device=state.particles.device)
    s, _ = call(state, inds[0])  # an eager warm-up iteration, the capture, a replay
    torch.cuda.synchronize()
    best = math.inf
    for rows in inds[1:]:
        t0 = time.perf_counter()
        s, _ = call(s, rows)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best / k * 1e3, 1 + (calls + 1) * k


def svgd_timing(torch, dev, prog, power_line: str) -> dict:
    """Phase 15's times: S1, S2, S3 and the three together (step_cuda) on
    the smc fit's cloud `prog` (its particles and amsgrad state after the
    timed steps, float32, P = 500, D = 18) and a N(0, 1) gradient, by graph
    replay (time_graph_ms) and eager (CUDA events, 20 launches); the plain
    version's pieces on the same card tensors (S1: the mask and the
    distances; S2: median_bandwidth's sort; S3: K, the two products and
    amsgrad; all: svgd.update_plain), the same two ways; torch.sort of the
    P^2 - P off-diagonal distances, S2's library call; the launch floor;
    roofline.svgd_bound; each kernel's geometry and ptxas registers.  Then
    the step's ablation rows "full" (prog's base_step) and "svgd-only (stub
    grad)" (tools/torch_step_profile.py's stub) by graph replay with the
    update through S1-S3 and through its plain version
    (svgd_plain_on_card), in turns (plain, kernels, kernels, plain), each
    run holding its exact S1-S3 launches or plain calls."""
    from phlash_tpu_torch import roofline, svgd
    from phlash_tpu_torch.ops import build
    from phlash_tpu_torch.ops import svgd as ops_svgd

    x = prog.state.particles.contiguous()
    o = prog.state.opt_state
    P, D = x.shape
    opt = svgd.AMSGrad(learning_rate=0.1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 151)
    g = torch.randn(P, D, generator=gen, device=dev, dtype=x.dtype)
    tri, xt, gt, sel = ops_svgd.distances_cuda(x, g)
    h = ops_svgd.bandwidth_cuda(tri, sel, P)
    gm = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    sq = ((x[:, None] - x[None]) ** 2).sum(-1)
    hp = svgd.median_bandwidth(sq, P)

    def s3_plain():
        K = torch.exp(-sq / hp)
        phi = (K @ gm - (2.0 / hp) * (K @ x - K.sum(1, keepdim=True) * x)) / P
        updates, o2 = opt.update(-phi, o)
        return x + updates, o2

    off = torch.sqrt(sq)[~torch.eye(P, dtype=torch.bool, device=dev)]
    fns = {
        "s1": (lambda: ops_svgd.distances_cuda(x, g),
               lambda: (torch.where(torch.isfinite(g), g, torch.zeros_like(g)),
                        ((x[:, None] - x[None]) ** 2).sum(-1))),
        "s2": (lambda: ops_svgd.bandwidth_cuda(tri, sel, P),
               lambda: svgd.median_bandwidth(sq, P)),
        "s3": (lambda: ops_svgd.update_cuda(x, xt, gt, h, slice(None), o.mu, o.nu, o.nu_max,
                                            o.count, opt), s3_plain),
        "update": (lambda: ops_svgd.step_cuda(x, g, slice(None), o, opt),
                   lambda: svgd.update_plain(x, g, slice(None), o, opt)),
    }
    t = {}
    for key, (kernel, plain) in fns.items():
        t[key], t[key + "_eager"] = time_graph_ms(torch, kernel), time_ms(torch, kernel, 20)
        t[key + "_plain"] = time_graph_ms(torch, plain)
        t[key + "_plain_eager"] = time_ms(torch, plain, 5)
    t["s2_library"] = time_graph_ms(torch, lambda: torch.sort(off))
    t["s2_library_eager"] = time_ms(torch, lambda: torch.sort(off), 20)
    one = torch.zeros(1, device=dev)
    t["launch_floor_graph"] = time_graph_ms(torch, lambda: one.add_(1.0))
    for key, name in zip(("s1", "s2", "s3"), roofline.SVGD_KERNELS):
        t[key + "_bound"] = roofline.svgd_bound(name, P, D, elem=x.element_size())
    t["update_bound"] = (sum(t[k + "_bound"][0] for k in ("s1", "s2", "s3")), "sum")
    t["shape"] = dict(P=P, D=D, dtype=str(x.dtype))
    t["geometry"] = ops_svgd.kernel_geometry(P, D)
    regs = ptxas_report(build.load_library().ptxas_log)
    t["registers"] = {k: v for k, v in regs.items() if k.startswith("svgd_")}
    print(f"svgd timing (P={P}, D={D}, {x.dtype}; {power_line}): ms a launch by graph replay / "
          f"eager, kernel against plain:")
    for key, what in (("s1", "S1 distances"), ("s2", "S2 bandwidth"), ("s3", "S3 update"),
                      ("update", "S1-S3 together")):
        bound = t[key + "_bound"]
        print(f"  {what:16s} {t[key]:.4f} / {t[key + '_eager']:.4f} ms; plain {t[key + '_plain']:.4f}"
              f" / {t[key + '_plain_eager']:.4f} ms; bound {bound[0]:.6f} ms ({bound[1]})")
    print(f"  torch.sort of the {off.numel()} off-diagonal distances (S2's library call): "
          f"{t['s2_library']:.4f} / {t['s2_library_eager']:.4f} ms; launch floor by graph "
          f"replay {t['launch_floor_graph']:.4f} ms; geometry {t['geometry']}; ptxas "
          f"{t['registers']}")

    # the ablation rows, the update through its kernels and its plain version, in turns
    stub = svgd.SVGD(lambda flat, **kw: torch.ones_like(flat), svgd.AMSGrad(learning_rate=0.1))
    rows = {"full": (prog.base_step, prog.state),
            "svgd-only (stub grad)": (lambda state, inds: stub.step(state),
                                      stub.init(prog.state.particles.clone()))}
    turns = {(row, mode): [] for row in rows for mode in ("plain", "kernels")}
    for mode in ("plain", "kernels", "kernels", "plain"):
        with svgd_plain_on_card() if mode == "plain" else contextlib.nullcontext():
            for row, (step, state) in rows.items():
                ops_svgd.reset_counts()
                ms, n = time_caller(torch, step, state, gen, prog.N, prog.S)
                check_counts(ops_svgd.counts(), svgd_counts(n, plain=mode == "plain"),
                             f"the {row} row with the update's {mode} version")
                turns[(row, mode)].append(ms)
    t["turns"] = {f"{row} ({mode})": v for (row, mode), v in turns.items()}
    print(f"svgd turns (plain, kernels, kernels, plain; ms an iteration by graph replay, "
          f"{power_line}): " + "; ".join(f"{k} {', '.join(f'{v:.4f}' for v in vs)}"
                                         for k, vs in t["turns"].items()))
    return t


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


def expected_counts(backend: str, niter: int = NITER, elpd: bool = True, spc: int = SPC) -> dict:
    """Launches of a fit (phases 4, 4b, 7, 8a, 12 and 14 with held-out data;
    phase 6 without), by ops module: niter iterations in calls of spc by
    graph replay, on fit's schedule (a call starting at iteration i carries
    the ELPD when no ELPD ran in the last ELPD_EVERY = 10 iterations), and
    one eager warm-up iteration (and ELPD) before the capture of each kind
    of call, (iterations, with ELPD).  At spc = 10 every call carries the
    ELPD, so one capture.  An smc iteration runs the warm-up filter and the
    likelihood, each B2 + B3; its ELPD two B1.  A packed iteration runs B4 +
    B5, its ELPD one B4.  Every iteration runs A1 + A2 (the assembly and its
    gradient) and S1 + S2 + S3 (the SVGD update), every ELPD one A1; the
    other backend's module launches nothing, and no plain version runs."""
    kinds, elpds, next_elpd = set(), 0, 0
    for i in range(0, niter, spc):
        with_elpd = elpd and i >= next_elpd
        if with_elpd:
            elpds, next_elpd = elpds + 1, i + 10
        kinds.add((min(spc, niter - i), with_elpd))
    steps, elpds = niter + len(kinds), elpds + sum(e for _, e in kinds)
    none = dict(forward_cuda=0, backward_cuda=0, forward_plain=0, backward_plain=0)
    out = {"smc": dict(none, forward_cuda_residuals=0), "packed": dict(none),
           "assembly": dict(none, forward_cuda=steps + elpds, backward_cuda=steps),
           "svgd": svgd_counts(steps)}
    if backend == "smc":
        out["smc"].update(forward_cuda=2 * steps + 2 * elpds, forward_cuda_residuals=2 * steps,
                          backward_cuda=2 * steps)
    else:
        out["packed"].update(forward_cuda=steps + elpds, backward_cuda=steps)
    return out


def svgd_counts(iters: int, plain: bool = False) -> dict:
    """ops/svgd.py's counts of `iters` SVGD iterations: S1, S2 and S3 once
    each an iteration, or with `plain` each plain version once instead."""
    kernels = 0 if plain else iters
    return dict(distances_cuda=kernels, bandwidth_cuda=kernels, update_cuda=kernels,
                bandwidth_plain=iters - kernels, direction_plain=iters - kernels,
                amsgrad_plain=iters - kernels)


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
# the filter and the likelihood, and A1, A2, S1, S2 and S3 once)
_UPDATE = {"S1": 1, "S2": 1, "S3": 1}
_SMC_SVGD = {"B2": 2, "B3": 2, "A1": 1, "A2": 1, **_UPDATE}
_PACKED_SVGD = {"B4": 1, "B5": 1, "A1": 1, "A2": 1, **_UPDATE}
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


def sum_counts(runs: list) -> dict:
    "Each ops module's launches summed over `runs` (counts dicts by module)."
    return {mod: {k: sum(c[mod][k] for c in runs) for k in runs[0][mod]} for mod in runs[0]}


def load_script(rel: str):
    "The repo's script at `rel` (a tool or walkthrough of the port, no JAX) as a module."
    import importlib.util

    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GENOME_TOOL = "tools/torch_genome_scale_demo.py"
GENOME_SECONDS = 900


def whole_genome_phase(card_name: str, power_line: str) -> dict:
    """Phase 11: the whole-genome path, `python tools/torch_genome_scale_demo.py
    --holdout` at scale 1.0 in its own process (a deadline; its VCFs in a
    temporary directory of the checkout), its lines echoed.  Fails unless it
    ran on phase 1's card; its chunk count is the sum over the training
    chromosomes of chunk_het_matrix's rows from their lengths; the fit
    launched exactly what its iterations and one capture imply (B2 and B3
    twice an iteration, A1 and A2 once, no ELPD), the timed plain calls what
    their replays imply, and the hold-out timing what its calls imply (each
    ELPD two B1 and one A1); packed launched nothing in any stage; the cloud
    is finite.  Returns each module's launches over the three stages."""
    tool = load_script(GENOME_TOOL)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke-") as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, GENOME_TOOL, "--holdout"], cwd=ROOT,
                              env=dict(os.environ, TMPDIR=tmp), capture_output=True, text=True,
                              timeout=GENOME_SECONDS)
        wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"genome: {line}")
    if proc.returncode != 0 or not lines:
        print(proc.stderr[-4000:], file=sys.stderr)
        fail(f"{GENOME_TOOL} exited with {proc.returncode}")
    out = json.loads(lines[-1])
    print(f"genome: {GENOME_TOOL} --holdout ran {wall:.1f} s on {power_line}")
    if out["device"] != card_name:
        fail(f"the genome tool ran on {out['device']!r}, not phase 1's {card_name!r}")
    lengths = [int(mb * 1e6) for mb in tool.CHROM_MB[:-1]]  # chr22 held out
    span = out["columns"]
    want_chunks = sum(max(1, -(-(L // 100) // span)) for L in lengths)
    if span != 600 or out["chunks"] != want_chunks:
        fail(f"the genome tool made {out['chunks']} chunks of {span} columns; the lengths give "
             f"{want_chunks} of 600")
    if not (out["finite"] and math.isfinite(out["median_c0"])):
        fail("the whole-genome fit's cloud is not finite")
    spc, niter = out["steps_per_call"], out["iterations"]
    if spc != SPC or niter != NITER:
        fail(f"the genome fit ran {niter} iterations in calls of {spc}")
    check_counts(out["launches_fit"], expected_counts("smc", niter=NITER, elpd=False),
                 "the whole-genome fit")

    def stage(iters: int, elpds: int) -> dict:
        "Each module's launches for `iters` iterations and `elpds` ELPDs on smc."
        none = dict(forward_cuda=0, backward_cuda=0, forward_plain=0, backward_plain=0)
        return {"smc": dict(none, forward_cuda=2 * iters + 2 * elpds,
                            forward_cuda_residuals=2 * iters, backward_cuda=2 * iters),
                "packed": none,
                "assembly": dict(none, forward_cuda=iters + elpds, backward_cuda=iters),
                "svgd": svgd_counts(iters)}

    check_counts(out["launches_timing"], stage(SPC * out["timed_calls"], 0),
                 "the whole-genome timing of plain calls")
    e = out["elpd"]
    # the ELPD graph's warm-up iteration and ELPD, eager, then its replays
    check_counts(out["launches_holdout"], stage(1 + SPC * e["elpd_calls"], 1 + e["elpd_calls"]),
                 "the whole-genome hold-out timing")
    print(f"genome summary ({power_line}): synthesis {out['synth_s']:.2f} s for "
          f"{out['gbp']:.3f} Gbp; ingestion {out['ingest_s']:.2f} s ({out['mbp_per_s']:.1f} "
          f"Mbp/s), {out['chunks']} chunks x {span} columns ({out['chunk_mb']:.1f} MB), peak "
          f"host RSS {out['peak_rss_gb']:.3f} GB; upload + build + first capture "
          f"{out['setup_s']:.2f} s; {out['ms_per_iter']:.4f} ms an iteration graphed (best of "
          f"{tool.REPS} runs of {tool.INNER} replays); "
          f"max_memory_allocated {out['max_memory_allocated_gb']:.3f} GB; median c[0] "
          f"{out['median_c0']:.4f}; ELPD overhead {100 * e['overhead']:.2f}% "
          f"({e['plain_call_ms']:.3f} / {e['elpd_call_ms']:.3f} ms a call)")
    return sum_counts([out[k] for k in ("launches_fit", "launches_timing", "launches_holdout")])


# phase 12: posterior recovery against the truth, tools/torch_validate.py at
# full size, once for each of these --n-samples (docs/validation_*.png and
# docs/validation_*_n2.png are the JAX tool's counterparts)
VALIDATE_TOOL = "tools/torch_validate.py"
VALIDATE_SAMPLES = (1, 2)
VALIDATE_SECONDS = 360
# (B, S, L) of B1-B3 against their plain versions before the validation: the
# validation fit's likelihood and held-out ELPD run on chunk bodies of 0.2 L
# = 100,000 windows (fit's default chunk; its warm-up filter, L = 500, is
# phase 3's) at B = 500 and S = 5.  The plain float64 versions dispatch every
# site from the host (~2.5 min a shape on an H100's host), so a ragged block
# is left to phase 3's L = 2501.
VALIDATE_GATE_SHAPES = ((500, 5, 100_000),)


def validation_phase(torch, smc, dev, power_line: str, tmp: str) -> tuple[dict, dict]:
    """Phase 12: B1-B3 at VALIDATE_GATE_SHAPES, M = 16, against their plain
    versions (gate_smc at phase 3's tolerances); then `python
    tools/torch_validate.py --n-samples n` at full size (L = 500,000, niter
    300, 500 particles, the continuous simulator) in its own process for
    each n of VALIDATE_SAMPLES (a deadline; plots under `tmp`), its lines
    echoed.  Fails unless it exits 0 (worst tv < 0.25) on phase 1's card;
    every tv and coverage is finite; and each fit launched exactly what the
    iterations it ran imply (expected_counts: one capture, an ELPD every
    call) on the smc kernels and A1 / A2, nothing packed and nothing plain.
    Coverage and each posterior's tv against the other demographies' truths
    are printed, not gated.  Returns each module's launches over every fit,
    and the long rows' gate errors."""
    errs = {"forward": {"abs": 0.0, "ll": 0.0, "state": 0.0}, "backward": {"abs": 0.0, "grad": 0.0}}
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    t0 = time.perf_counter()
    for B, S, L in VALIDATE_GATE_SHAPES:
        params, pi, obs = random_instances(torch, 16, B, S, L, dev, gen)
        gbar = torch.randn(B, S, generator=gen, device=dev, dtype=torch.float64)
        abar0 = torch.randn(B, S, 16, generator=gen, device=dev, dtype=torch.float64)
        gate_smc(torch, smc, params, pi, obs, gbar, abar0, f"M=16 B={B} S={S} L={L}", errs)
        del params, pi, obs
        torch.cuda.empty_cache()
    print(f"validation: B1-B3 at the fit's chunk length checked in "
          f"{time.perf_counter() - t0:.1f} s on {power_line}")
    runs = []
    for n in VALIDATE_SAMPLES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, VALIDATE_TOOL, "--n-samples", str(n),
                               "--plot-dir", tmp], cwd=ROOT, env=dict(os.environ, TMPDIR=tmp),
                              capture_output=True, text=True, timeout=VALIDATE_SECONDS)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        for line in lines:
            print(f"validate n={n}: {line}")
        if proc.returncode != 0 or len(lines) < 2:
            print(proc.stderr[-4000:], file=sys.stderr)
            fail(f"{VALIDATE_TOOL} --n-samples {n} exited with {proc.returncode}")
        out = json.loads(lines[-2])
        if out["card"] != power_line:
            fail(f"the validation ran on {out['card']!r}, not phase 1's {power_line!r}")
        if (out["L"], out["niter"], out["particles"]) != (500_000, 300, 500):
            fail(f"the validation ran at L={out['L']}, niter={out['niter']}, "
                 f"{out['particles']} particles, not at full size")
        for r in out["demographies"]:
            if not (math.isfinite(r["tv"]) and math.isfinite(r["coverage"]) and r["finite"]):
                fail(f"validation {r['name']}: tv {r['tv']}, coverage {r['coverage']}, "
                     f"finite models {r['finite']}")
            iters = r["iterations"]
            if iters % SPC or not 0 < iters <= out["niter"]:
                fail(f"validation {r['name']} ran {iters} iterations")
            check_counts(r["launches"], expected_counts("smc", niter=iters),
                         f"the validation fit of {r['name']}")
            runs.append(r["launches"])
            print(f"validation {r['name']} ({power_line}): tv {r['tv']:.4f}, coverage "
                  f"{r['coverage']:.4f} (not gated), {iters} iterations, fit wall "
                  f"{r['wall_s']:.2f} s (graph set-up {r['graph_setup_s']:.2f} s); tv against "
                  f"the other truths (not gated): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in r["tv_other_truths"].items()))
        print(f"validation n={n}: worst tv {out['worst_tv']:.4f} < {out['tv_gate']}; "
              f"{VALIDATE_TOOL} ran {wall:.1f} s on {power_line}")
    return sum_counts(runs), errs


# phase 13: the step's ablation profile, tools/torch_step_profile.py at its
# defaults; each row's launches an iteration (B2 + B3 pairs, A1 + A2 pairs,
# S1 + S2 + S3 triples)
PROFILE_TOOL = "tools/torch_step_profile.py"
PROFILE_SECONDS = 300
PROFILE_ROWS = {"full": (2, 1, 1), "-afs": (2, 1, 1), "-warmup": (1, 1, 1),
                "-sites (64-site chunks)": (2, 1, 1), "svgd-only (stub grad)": (0, 0, 1),
                "kernel fwd+grad only": (1, 0, 0), "assembly fwd+grad only": (0, 1, 0)}


def ablation_phase(torch, smc, dev, power_line: str) -> tuple[dict, dict]:
    """Phase 13: B2 + B3 at the -sites row's L = 64 (the fit's B = 500, S =
    5 and a ragged B = 37, S = 3) against their plain versions (gate_smc,
    with its float32 floor on the ll); then `python tools/torch_step_profile.py` at its
    defaults in its own process (a deadline), its lines echoed.  Fails
    unless every row of PROFILE_ROWS is there with finite, positive graphed
    and eager ms, and each row launched exactly its B2 + B3 and A1 + A2
    pairs and S1 + S2 + S3 triples an iteration for the iterations it ran
    and nothing else (no B1, nothing packed, nothing plain): so -warmup no
    filter, svgd-only the update's kernels alone.  Returns each module's launches over every row, and the L = 64
    gate's errors."""
    errs = {"forward": {"abs": 0.0, "ll": 0.0, "state": 0.0}, "backward": {"abs": 0.0, "grad": 0.0}}
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    for B, S in ((500, 5), (37, 3)):
        params, pi, obs = random_instances(torch, 16, B, S, 64, dev, gen)
        gbar = torch.randn(B, S, generator=gen, device=dev, dtype=torch.float64)
        abar0 = torch.randn(B, S, 16, generator=gen, device=dev, dtype=torch.float64)
        gate_smc(torch, smc, params, pi, obs, gbar, abar0, f"M=16 B={B} S={S} L=64", errs,
                 f32_floor=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, PROFILE_TOOL], cwd=ROOT, capture_output=True,
                          text=True, timeout=PROFILE_SECONDS)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        if not line.startswith("{"):
            print(f"ablation: {line}")
    if proc.returncode != 0 or not lines:
        print(proc.stderr[-4000:], file=sys.stderr)
        fail(f"{PROFILE_TOOL} exited with {proc.returncode}")
    rows = {d["row"]: d for d in map(json.loads, (x for x in lines if x.startswith('{"row"')))}
    last = json.loads(lines[-1])
    if list(last) != list(PROFILE_ROWS) or list(rows) != list(PROFILE_ROWS):
        fail(f"the ablation's rows are {list(last)} / {list(rows)}, not {list(PROFILE_ROWS)}")
    for name, (hmm, asm, upd) in PROFILE_ROWS.items():
        d, n = rows[name], rows[name]["iterations"]
        if not all(math.isfinite(d[k]) and d[k] > 0 for k in ("graphed_ms", "eager_ms")) \
                or last[name] != d["graphed_ms"]:
            fail(f"the ablation's row {name!r} reads {d['graphed_ms']} / {d['eager_ms']} ms")
        none = dict(forward_cuda=0, backward_cuda=0, forward_plain=0, backward_plain=0)
        want = {"smc": dict(none, forward_cuda=hmm * n, forward_cuda_residuals=hmm * n,
                            backward_cuda=hmm * n),
                "packed": none, "assembly": dict(none, forward_cuda=asm * n, backward_cuda=asm * n),
                "svgd": svgd_counts(upd * n)}
        check_counts(d["launches"], want, f"the ablation's row {name!r} ({n} iterations)")
        print(f"ablation {name} ({power_line}): {d['graphed_ms']:.4f} ms graphed, "
              f"{d['eager_ms']:.4f} ms eager; {n} iterations, {hmm} B2 + B3, {asm} A1 + A2 and "
              f"{upd} S1 + S2 + S3 an iteration")
    print(f"ablation: {PROFILE_TOOL} ran {wall:.1f} s on {power_line}")
    return sum_counts([d["launches"] for d in rows.values()]), errs


# phase 14: the walkthrough, docs/torch_example.py at its own full size
EXAMPLE = "docs/torch_example.py"
EXAMPLE_SECONDS = 300


def fit_call(main):
    "The `....fit(...)` call in `main`'s source, as an ast.Call."
    import ast
    import inspect

    return next(n for n in ast.walk(ast.parse(inspect.getsource(main)))
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "fit")


def fit_call_options(main) -> dict:
    """The keywords of `main`'s fit call that are literals, or names of
    main's parameters (read at their defaults): a walkthrough's fit options
    as docs/example.py and docs/torch_example.py both write them."""
    import ast
    import inspect

    defaults = {k: p.default for k, p in inspect.signature(main).parameters.items()}
    out = {}
    for kw in fit_call(main).keywords:
        if isinstance(kw.value, ast.Constant):
            out[kw.arg] = kw.value.value
        elif isinstance(kw.value, ast.Name) and kw.value.id in defaults:
            out[kw.arg] = defaults[kw.value.id]
    return out


def example_shapes(ex, tmp: str) -> dict:
    """The walkthrough's kernel shapes at its full size, from the fit's own
    chunking of its own data (its BCF written to `tmp`, the regions it
    loads): (B, S, L) of the training step's likelihood (the chunk bodies)
    and warm-up filter (the overlap), then of the held-out ELPD's (S =
    min(held-out chunks, max(S, 4)), mcmc.held_out_elpd's default); B is the
    cloud.  Returns them as `gate` with the counts they come from."""
    import inspect

    from phlash_tpu_torch.data import chunk_het_matrix, init_mcmc_data
    from phlash_tpu_torch.training import resolve_minibatch_size

    opts = fit_call_options(ex.main)
    L_windows = inspect.signature(ex.main).parameters["L_windows"].default
    path = os.path.join(tmp, "shapes.bcf")
    _, span = ex.simulate_to_bcf(path, L_windows)
    train, held_out = ex.load(path, span)
    overlap, B = opts["overlap"], opts["num_particles"]
    _, chunks = init_mcmc_data([train], ex.WINDOW, overlap, opts["chunk_size"], num_workers=1)
    body = chunks.shape[1] - overlap
    S = resolve_minibatch_size(opts, len(chunks), opts["niter"])
    test = chunk_het_matrix(held_out.get_data(ex.WINDOW)["het_matrix"], overlap, body)
    S_elpd = min(len(test), max(S, 4))
    gate = tuple(dict.fromkeys((B, s, L) for s in (S, S_elpd) for L in (body, overlap)))
    return dict(options=opts, L_windows=L_windows, chunks=len(chunks), held_out_chunks=len(test),
                S=S, S_elpd=S_elpd, gate=gate)


def example_phase(torch, smc, dev, power_line: str, tmp: str) -> tuple[dict, dict]:
    """Phase 14: B1-B3 at the walkthrough's shapes (example_shapes, M = 16)
    against their plain versions (gate_smc at phase 3's tolerances); then
    `python docs/torch_example.py <tmp>/example` at its full size in its own
    process (a deadline), its lines echoed.  Fails unless it exits 0 with
    DONE; its card line names phase 1's card; its checkpoint holds the cloud
    of B particles after 0 < iterations <= niter; the band is ordered
    (upper Ne >= lower - 1e-9 on its grid); and the fit launched exactly
    what those iterations imply in calls of its steps_per_call, its ELPDs
    and one capture of each kind of call (expected_counts), on the smc
    kernels and A1 / A2, nothing packed and nothing plain.  Prints the
    gate's and the script's seconds.  Returns the fit's launches by module
    and the gate's errors."""
    import numpy as np

    errs = {"forward": {"abs": 0.0, "ll": 0.0, "state": 0.0}, "backward": {"abs": 0.0, "grad": 0.0}}
    t_phase = time.perf_counter()
    ex = load_script(EXAMPLE)
    sh = example_shapes(ex, tmp)
    opts = sh["options"]
    print(f"example: {sh['L_windows']} windows, {sh['chunks']} training chunks (S = {sh['S']}) "
          f"and {sh['held_out_chunks']} held-out (S = {sh['S_elpd']} an ELPD) of "
          f"{opts['chunk_size']} + {opts['overlap']}; gate shapes (B, S, L) {sh['gate']}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    for B, S, L in sh["gate"]:
        params, pi, obs = random_instances(torch, 16, B, S, L, dev, gen)
        gbar = torch.randn(B, S, generator=gen, device=dev, dtype=torch.float64)
        abar0 = torch.randn(B, S, 16, generator=gen, device=dev, dtype=torch.float64)
        gate_smc(torch, smc, params, pi, obs, gbar, abar0, f"M=16 B={B} S={S} L={L}", errs)
    gate_s = time.perf_counter() - t_phase
    out = Path(tmp) / "example"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, EXAMPLE, str(out)], cwd=ROOT,
                          env=dict(os.environ, TMPDIR=tmp), capture_output=True, text=True,
                          timeout=EXAMPLE_SECONDS)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        print(f"example: {line}")
    if proc.returncode != 0 or not lines or not lines[-1].startswith("DONE"):
        print(proc.stderr[-4000:], file=sys.stderr)
        fail(f"{EXAMPLE} exited with {proc.returncode}")
    cards = [json.loads(x[len("card: "):]) for x in lines if x.startswith("card: ")]
    if len(cards) != 1 or cards[0]["card"] != power_line:
        fail(f"the walkthrough's card lines {cards} do not name phase 1's {power_line!r}")
    card, ckpt = cards[0], out / "fit_ckpt.npz"
    if not ckpt.is_file():
        fail(f"the walkthrough wrote no checkpoint {ckpt}")
    with np.load(ckpt) as z:
        iters, P = int(z["__meta"][0]), z["particles"].shape[0]
    if P != opts["num_particles"] or not 0 < iters <= opts["niter"]:
        fail(f"the walkthrough's checkpoint holds {P} particles after {iters} iterations")
    gap = card["band_min_gap"]
    if not (math.isfinite(gap) and gap >= -1e-9):
        fail(f"the walkthrough's band is not ordered: least upper - lower Ne(t) {gap}")
    check_counts(card["launches"], expected_counts("smc", iters, spc=opts["steps_per_call"]),
                 f"the walkthrough's fit ({iters} iterations)")
    print(f"example ({power_line}): {iters} of {opts['niter']} iterations in calls of "
          f"{opts['steps_per_call']}, {P} particles, band over {card['band_points']} points "
          f"(least upper - lower Ne(t) {gap:.6g}); launches {card['launches']}; gate "
          f"{gate_s:.1f} s + {EXAMPLE} {wall:.1f} s = phase 14 "
          f"{time.perf_counter() - t_phase:.1f} s")
    return card["launches"], errs


def kernel_entry(name, source, replaces, launches, genome_launches, mesh_launches,
                 bench_launches, errs, gate, t, key, later_launches):
    """One kernel of the JSON summary line; `key` names its times in `t`.
    `launches` counts phase 4 / 4b's fit of its path, `genome_launches`
    phase 7's fit from genome files, `mesh_launches` phase 8a's meshed fit,
    `bench_launches` phase 9's bench over its timed windows,
    `later_launches` phase 3d's per-particle entries, phase 11's whole
    genome, phase 12's validation fits, phase 13's ablation rows and phase
    14's walkthrough: (3d, 11, 12, 13, 14)."""
    ms_bound, by = t[key + "_bound"]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "launches_by_path": {"psmcfa (phase 4/4b)": launches,
                                 "genome files (phase 7)": genome_launches,
                                 "mesh of one (phase 8a)": mesh_launches,
                                 "bench (phase 9)": bench_launches,
                                 "per-particle entries (phase 3d)": later_launches[0],
                                 "whole genome (phase 11)": later_launches[1],
                                 "validation (phase 12)": later_launches[2],
                                 "ablation (phase 13)": later_launches[3],
                                 "walkthrough (phase 14)": later_launches[4]},
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


class Laps:
    "Each phase's seconds in main(), in order: lap(name) closes the phase `name`."

    def __init__(self):
        self.t, self.seconds = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self.t, 1)
        self.t = now


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="profile 5 SVGD steps of each path")
    args = ap.parse_args()
    t_start = time.perf_counter()
    lap = Laps()
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
    from phlash_tpu_torch.ops import svgd as svgd_ops

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
    lap("1-2 device, build")

    # 3. kernels against their plain versions
    errs = check_kernels(torch, smc, dev)
    perrs = check_packed_kernels(torch, packed, dev)
    lap("3, 3b")
    # 3c. the assembly kernels
    aerrs = check_assembly(torch, dev)
    lap("3c")
    # 3d. the per-particle entries
    pp3d = per_particle_phase(torch, dev)
    lap("3d")
    # 15, first part: the SVGD update's kernels (S1-S3) against their plain versions
    serrs = check_svgd(torch, dev)
    lap("15 gate")

    # 4. the slice, once per hand-kernel backend, by graph replays
    ops = {"smc": smc, "packed": packed, "assembly": assembly, "svgd": svgd_ops}
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
    lap("4-4e")

    # 3 and 3b, continued: each pair on its fit's late inputs
    check_fit_inputs(torch, smc, dev, late, errs)
    check_packed_fit_inputs(torch, packed, dev, packed_late, perrs)
    lap("3, 3b late inputs")

    # 5. kernel times at the fit shape
    t = kernel_timing(torch, smc, dev, {**smc_inputs, **late})
    pt = packed_timing(torch, packed, dev, fit_inputs)
    at = assembly_timing(torch, dev, built["smc"][0])
    # 5c. the scan backend against the smc kernels
    check_scan(torch, dev)
    lap("5, 5c")

    # 6. posterior reproduction against phlash_tpu.fit
    repro_phase(torch, ops)
    lap("6")

    # 7. from genome files to a posterior
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke-") as tmp:
        gcounts = genome_phase(torch, ops, dev, tmp)
    lap("7")

    # 8. the meshed fit, simulate_hmm and the profiler block
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke-") as tmp:
        mcounts = mesh_phase(torch, ops, dev, tmp, {"smc": smc_models, "packed": packed_models},
                             {b: prog for b, (prog, _, _) in built.items()})
        sim_phase(torch, dev, tmp)
        trace_phase(torch, built["smc"][0], dev, tmp)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    lap("8")

    # 9. the port's bench, in its own process
    torch.cuda.empty_cache()
    blaunch = bench_phase(smi.stdout.splitlines()[0].split(",")[0].strip())
    lap("9")

    # 10. the issue-rate micro-kernels (B6): the card check and the sweep
    pk = peak_phase(torch, dev, lib)
    lap("10")

    # 11. the whole genome, in its own process
    torch.cuda.empty_cache()
    wg = whole_genome_phase(kind, smi.stdout.strip())
    lap("11")

    # 12. posterior recovery against the truth, in its own processes
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke-") as tmp:
        va, errs_long = validation_phase(torch, smc, dev, smi.stdout.strip(), tmp)
    lap("12")

    # 13. the step's ablation profile, in its own process
    ab, errs64 = ablation_phase(torch, smc, dev, smi.stdout.strip())
    lap("13")

    # 14. the walkthrough, in its own process
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke-") as tmp:
        wk, errs_example = example_phase(torch, smc, dev, smi.stdout.strip(), tmp)
    lap("14")

    # 15, second part: the SVGD update's times, and the ablation rows in turns
    st = svgd_timing(torch, dev, built["smc"][0], smi.stdout.strip())
    lap("15 times")

    if "jax" in sys.modules or "phlash_tpu" in sys.modules:
        fail("JAX or phlash_tpu was imported")
    print(f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s before its summary")
    print(f"phase seconds: {json.dumps(lap.seconds)}")
    print(f"svgd_update_ms (S1-S3 by graph replay, P=500, float32): {st['update']:.4f}; plain "
          f"{st['update_plain']:.4f}; svgd_kernel_check_cases {serrs['cases']}")
    print("svgd_step_ms_per_iter: " + " ".join(f"{b} {mode} {v:.3f}"
                                                for (b, mode), v in step_ms.items()))
    src = "phlash_tpu_torch/csrc/"
    smc_fwd = {"max_abs_err": errs["forward"]["abs"], "max_rel_err_ll": errs["forward"]["ll"],
               "max_rel_err_alpha_pstates": errs["forward"]["state"]}
    smc_gate = "rel: ll 1e-5, alpha and pstates 1e-4; B1 equal to B2 bitwise"
    sc, pc, gc = counts["smc"], pcounts["packed"], gcounts["smc"]

    def later(mod: str, key: str) -> tuple:
        "A kernel's launches in phases 3d, 11, 12, 13 and 14."
        return tuple(c[mod][key] for c in (pp3d["launches"], wg, va, ab, wk))

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
    entries = [
        kernel_entry("smc_forward", src + "smc_forward.cu", "phlash_tpu/ops/pallas_smc.py:358",
                     sc["forward_cuda"] - sc["forward_cuda_residuals"],
                     gc["forward_cuda"] - gc["forward_cuda_residuals"],
                     msc["forward_cuda"] - msc["forward_cuda_residuals"],
                     blaunch.get("B1", 0), smc_fwd, smc_gate, t, "fwd",
                     tuple(c["smc"]["forward_cuda"] - c["smc"]["forward_cuda_residuals"]
                           for c in (pp3d["launches"], wg, va, ab, wk))),
        kernel_entry("smc_forward_residuals", src + "smc_forward.cu",
                     "phlash_tpu/ops/pallas_smc.py:358", sc["forward_cuda_residuals"],
                     gc["forward_cuda_residuals"], msc["forward_cuda_residuals"],
                     blaunch.get("B2", 0), smc_fwd, smc_gate, t, "fwd_res",
                     later("smc", "forward_cuda_residuals")),
        kernel_entry("smc_backward", src + "smc_backward.cu", "phlash_tpu/ops/pallas_smc.py:511",
                     sc["backward_cuda"], gc["backward_cuda"], msc["backward_cuda"],
                     blaunch.get("B3", 0),
                     {"max_abs_err": errs["backward"]["abs"],
                      "max_normalized_err": errs["backward"]["grad"]},
                     "max|err| / max|plain| per gradient 2e-5", t, "bwd",
                     later("smc", "backward_cuda")),
        kernel_entry("packed_forward", src + "packed_forward.cu",
                     "phlash_tpu/ops/pallas_hmm.py:162", pc["forward_cuda"], 0,
                     mpc["forward_cuda"], blaunch.get("B4", 0),
                     {"max_abs_err": perrs["forward"]["abs"],
                      "max_rel_err_ll": perrs["forward"]["ll"],
                      "max_rel_err_ckpt": perrs["forward"]["ckpt"]},
                     "rel: ll 1e-5, ckpt 1e-4", pt, "fwd",
                     later("packed", "forward_cuda")),
        kernel_entry("packed_backward", src + "packed_backward.cu",
                     "phlash_tpu/ops/pallas_hmm_vjp.py:155", pc["backward_cuda"], 0,
                     mpc["backward_cuda"], blaunch.get("B5", 0),
                     {"max_abs_err": perrs["backward"]["abs"],
                      "max_normalized_err": perrs["backward"]["grad"]},
                     "max|err| / max|plain| per gradient 2e-5", pt, "bwd",
                     later("packed", "backward_cuda")),
        {**kernel_entry("assembly_forward", src + "assembly.cu", replaces,
                        asm["smc"][0]["forward_cuda"], gcounts["assembly"]["forward_cuda"],
                        asm["smc"][1]["forward_cuda"], blaunch.get("A1", 0), asm_errs,
                        asm_gate, at, "a1",
                        later("assembly", "forward_cuda")),
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
                        asm_gate, at, "a2",
                        later("assembly", "backward_cuda")),
         "launches_packed_path": asm["packed"][0]["backward_cuda"],
         "launch_floor_ms": at["launch_floor"], "launch_floor_graph_ms": at["launch_floor_graph"],
         "ms_eager": at["a2_eager"], "ms_n_minus_1_15": at["a2_n16"],
         "ms_eager_n_minus_1_15": at["a2_eager_n16"],
         "shape": at["shape"], "geometry": at["geometry"]["A2"],
         "design": "A1's forward, then one reverse pass: suffix scans for the occupancy and "
                   "the prefix sums, each interval's local adjoint on width-3 dual numbers"},
        peak_entry(src, pk),
    ]
    update_gate = ("S1: x^T and masked g^T bitwise, the first digit exact, the triangle within "
                   "2 (D + 2) units of roundoff of plain float64; S2: h bitwise the sort's "
                   "(median_bandwidth) and the selection's on the card in float32 and float64; S3: "
                   "particles and moments within 1e-6 (float32) / 1e-12 (float64) of max|plain "
                   "float64|, the count exact; P in 500, 48, 37, 32, 8, 3, 2, D in 18, 40, random, "
                   "ties, lattice and degenerate clouds, inf and NaN gradient rows, rows all and "
                   "a mesh block; S1 and S2 bitwise their first launch over repeats, also on two "
                   "streams at once")
    update_errs = {"max_abs_err": serrs["abs"]["state"],
                   "max_normalized_err_f32": serrs["state"]["float32"],
                   "max_normalized_err_f64": serrs["state"]["float64"],
                   "plain_f32_control_normalized_err": serrs["plain_f32"]["clouds"],
                   "plain_f32_control_normalized_err_degenerate": serrs["plain_f32"]["degenerate"]}
    for name, key, counter, errs_k, design in (
            ("svgd_distances", "s1", "distances_cuda",
             {"max_abs_err": serrs["abs"]["tri"], "max_err_over_bound": serrs["tri"]},
             "a thread a pair, the cloud in shared memory; the first digit of S2's selection "
             "histogrammed over the blocks, the last block picks its bin"),
            ("svgd_bandwidth", "s2", "bandwidth_cuda", {"max_abs_err": serrs["abs"]["h"],
                                                         "repeats_bitwise": serrs["repeats"]},
             "exact radix selection on the float bits (13-bit digits): the second digit over "
             "64 blocks, which bucket their candidates; the last block picks the bin and selects "
             "among the candidates in shared memory"),
            ("svgd_update", "s3", "update_cuda", update_errs,
             "a block a row, lanes on columns: K in registers, sums in double, lanes by "
             "butterfly and warps in order; amsgrad in the cloud's dtype")):
        e = kernel_entry(name, src + "svgd.cu", "phlash_tpu/svgd.py:32-76, 79-130",
                         counts["svgd"][counter], gcounts["svgd"][counter],
                         mcounts["smc"]["svgd"][counter],
                         blaunch.get("S" + key[1], 0), errs_k, update_gate, st, key,
                         later("svgd", counter))
        e["launches_by_path"]["psmcfa packed (phase 4b)"] = pcounts["svgd"][counter]
        e.update(ms_eager=st[key + "_eager"], plain_ms_eager=st[key + "_plain_eager"],
                 library_ms=st["s2_library"] if key == "s2" else None, shape=st["shape"],
                 registers={k: v for k, v in st["registers"].items() if k.startswith(name)},
                 design=design)
        entries.append(e)
    entries[-1].update(update_ms=st["update"], update_plain_ms=st["update_plain"],
                       update_ms_eager=st["update_eager"],
                       update_plain_ms_eager=st["update_plain_eager"], geometry=st["geometry"],
                       ablation_turns_ms=st["turns"])
    one_particle = {"smc_forward": "B1", "smc_forward_residuals": "B2", "smc_backward": "B3",
                    "packed_forward": "B4", "packed_backward": "B5"}
    for e in entries:
        if e["name"] in one_particle:  # phase 3d: (B, S) = (1, 5) by graph replay
            e["ms_one_particle_s5"] = pp3d["ms"][e["name"].split("_")[0]][one_particle[e["name"]]]
        if e["name"].startswith("smc_"):  # phases 12-14: the validation's, -sites', walkthrough's
            e["errors_L100000"] = errs_long
            e["errors_L64"] = errs64
            e["errors_example"] = errs_example  # phase 14: the walkthrough's shapes
            e["gate_L64"] = ("as the gate, but an instance's ll within max(1e-5 |ll|, 2x the "
                             "plain float32 forward's error on it)")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
