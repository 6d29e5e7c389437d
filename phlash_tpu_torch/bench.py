"""Throughput of the port on one card: `python -m phlash_tpu_torch bench`.

The counterpart of phlash_tpu's bench.py (which `python -m phlash_tpu bench`
runs on a TPU host), timed on the card through the hand kernels.  It prints
exactly one JSON line in the shape of that bench's line: `metric`, `value`
(Msites/s of the value-and-gradient pass; sites = B * S * L observation
columns), `unit`, `vs_baseline` and `extra`.

Workload (the JAX bench's, bench.py:119-126): Bernoulli(0.05) int8 rows
from numpy seed 0 with a missing stretch at sites 1000-1100, the default
demographic model's PSMCParams at M = 16 in float32, broadcast to
B = 500 particles x S = 5 chunks, L = 20,000 sites.  Parts, in order:

- gate: the `smc` kernels, through this module's loss, against their plain
  float64 version (ops/smc.py) on the same device at B = 8, S = 2,
  L = 1200: ll within 1e-5 relative, every leaf's gradient within 2e-5 of
  max|plain| (chip_smoke.py's limits).  A failed gate prints the line with
  "value": null and main() returns 1; nothing is timed.
- number of record: `smc` fwd+grad (B2 + B3) and fwd-only (B1), inner =
  10 calls between fences, reps = 3, the best rep; one re-measure when the
  fwd+grad reps spread by 10% or more, keeping the window that spreads
  less (`device_health`, `noisy_window_retries`);
- baseline: the `scan` backend (hmm.ScanKernel, plain PyTorch, the JAX
  bench's PureXLAKernel) on the same device at L = 1000, inner = 3;
- M = 32 and 64 on `smc` (reps = 2), and the `packed` backend (B4, B5) at
  M = 16 on the same inputs;
- the SVGD step: the JAX bench's program (rng 1: 2000 chunks of 2500
  Bernoulli(0.05) sites and 9 AFS entries; window 100, overlap 500, 500
  particles, S = 5, niter 1000) through training.build_training, whose
  step is a CUDA graph of steps_per_call = 10 iterations; minibatch indices
  drawn as mcmc.fit draws them.  The first call (warm-up and capture) is
  timed apart; then the best of 3 windows of 3 calls.  The same on
  `packed` at overlap 0.  Each iteration runs the assembly kernels once
  (A1 forward, A2 its gradient; ops/assembly.py) beside the HMM kernels;
- the assembly alone on the `smc` program's 500 particles and AFS (9
  entries): A1 and A2 ms a launch, the best of `reps` windows of `inner`
  launches.

Every timed window reads the launch counters (ops/smc.counts,
ops/packed.counts, ops/assembly.counts; graph replays count through
add_counts) and fails unless it launched exactly the kernels it is named
for, once per call or iteration (the smc SVGD step twice each HMM kernel).
On the card each number stands beside the card's name and power
limit and its SM clock and power draw before and after the timed windows;
roofline shares (roofline.py) above 1 fail the run, and so do the smc
kernels' shares of the issue ceiling and of the shuffle path
(`sm_issue_peak_fraction_*`, `sm_shuffle_peak_fraction_*`: their counted
instructions a site over the data-sheet rates, roofline.issue_share; the
counterpart of phlash_tpu's `vpu_issue_peak_fraction_*`).  The issue count
is the source's, and two of its terms are estimates, not counts: a float
division's instructions (roofline.DIV_NEXT) and logf's (roofline.LOGF); the
built kernels' loops hold more instructions than the count (B1 99.9 against
76.9 a lane-site, B3 231.5 against 198.9, tools/torch_sm_peak.py --sass on
an H100), so the issue shares read low.  The shuffle count is exact.  The bench does
not run the micro-kernel sweep (tools/torch_sm_peak.py), as phlash_tpu's
does not run tools/vpu_peak.py.  `device="cpu"` runs
the plain versions and leaves every device number null: no CPU time is
written under a device's name.  No part's failure is caught.
"""

from __future__ import annotations

import json
import logging
import subprocess
import time

import numpy as np
import torch

from phlash_tpu_torch import roofline
from phlash_tpu_torch.kernel import get_kernel, resolve_device
from phlash_tpu_torch.mcmc import generators
from phlash_tpu_torch.ops import assembly, packed, smc
from phlash_tpu_torch.params import PSMC_FIELDS, PSMCParams
from phlash_tpu_torch.size_history import DemographicModel
from phlash_tpu_torch.training import build_training

logger = logging.getLogger(__name__)

METRIC = "HMM fwd+grad throughput (M=16, B=500, S=5, f32)"
PARTICLE_FIELDS = PSMC_FIELDS[:6]  # the per-particle leaves; pi is per instance
GATE_LL_RTOL = 1e-5
GATE_GRAD = 2e-5  # max|err| / max|plain| per leaf
NOISY = 0.10  # rep spread from which a window counts as noisy

# what one call launches: by kernel on the card, by plain version on the CPU
LAUNCHES = {
    ("smc", "fwd_only", "cuda"): ("B1",),
    ("smc", "fwd_grad", "cuda"): ("B2", "B3"),
    ("packed", "fwd_only", "cuda"): ("B4",),
    ("packed", "fwd_grad", "cuda"): ("B4", "B5"),
    ("smc", "fwd_only", "cpu"): ("smc_plain_forward",),
    ("smc", "fwd_grad", "cpu"): ("smc_plain_forward", "smc_plain_backward"),
    ("packed", "fwd_only", "cpu"): ("packed_plain_forward",),
    ("packed", "fwd_grad", "cpu"): ("packed_plain_forward", "packed_plain_backward"),
}
SVGD_PASSES = {"smc": 2, "packed": 1}  # fwd+grad passes an iteration (smc: filter and likelihood)
# the assembly's forward and gradient, once an SVGD iteration, by device
ASSEMBLY = {"cuda": ("A1", "A2"), "cpu": ("assembly_plain_forward", "assembly_plain_backward")}


def workload(M: int = 16, B: int = 500, S: int = 5, L: int = 20_000, device="cuda"):
    """The JAX bench's inputs: int8 rows (max(8, S), L) with a missing
    stretch at sites 1000-1100, PSMCParams of the default model at M
    (pattern "M*1") in float32 with every leaf broadcast to (B, S, M), and
    the chunk indices arange(S)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    data = rng.binomial(1, 0.05, size=(max(8, S), L)).astype(np.int8)
    data[:, 1000:1100] = -1  # a missing stretch, so that path is in the timing
    dm = DemographicModel.default(pattern=f"{M}*1", theta=1e-2, rho=1e-2)
    pp = PSMCParams.from_dm(dm).to(dtype=torch.float32, device=dev)
    pps = PSMCParams(*(getattr(pp, k).expand(B, S, -1).contiguous() for k in PSMC_FIELDS))
    return data, pps, torch.arange(S, device=dev)


def loss(kern, pps: PSMCParams, inds: torch.Tensor) -> torch.Tensor:
    """The JAX bench's loss: the sum of kern's (B, S) log-likelihoods.  The
    per-particle leaves are read at chunk 0, as phlash_tpu's SMCKernel reads
    them, so their gradient lands there; pi is per instance."""
    pp = PSMCParams(*(getattr(pps, k)[:, 0] for k in PARTICLE_FIELDS), pi=pps.pi)
    return kern.loglik_batched(pp, inds).sum()


def passes(kern, pps: PSMCParams, inds: torch.Tensor):
    "(fwd+grad, fwd-only) of `loss`: zero-argument calls to time."
    leaves = [getattr(pps, k).detach().requires_grad_() for k in PSMC_FIELDS]
    pps = PSMCParams(*leaves)

    def fwd_grad():
        return torch.autograd.grad(loss(kern, pps, inds), leaves)

    def fwd():
        with torch.no_grad():
            return loss(kern, pps, inds)

    return fwd_grad, fwd


def launches() -> dict:
    "The hand kernels' launch counters and their plain versions' calls, by name."
    s, p, a = smc.counts(), packed.counts(), assembly.counts()
    return {"B1": s["forward_cuda"] - s["forward_cuda_residuals"],
            "B2": s["forward_cuda_residuals"], "B3": s["backward_cuda"],
            "B4": p["forward_cuda"], "B5": p["backward_cuda"],
            "A1": a["forward_cuda"], "A2": a["backward_cuda"],
            "smc_plain_forward": s["forward_plain"], "smc_plain_backward": s["backward_plain"],
            "packed_plain_forward": p["forward_plain"],
            "packed_plain_backward": p["backward_plain"],
            "assembly_plain_forward": a["forward_plain"],
            "assembly_plain_backward": a["backward_plain"]}


class Launches:
    """The counters' deltas of each named window; `check` fails a window
    that did not launch exactly `names` `n` times each (and the kernels of
    `extra`, name -> launches, as often as it says), and nothing else."""

    def __init__(self):
        self.windows: dict[str, dict] = {}

    def count(self, name: str, run):
        before = launches()
        out = run()
        after = launches()
        self.windows[name] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        return out

    def check(self, name: str, names: tuple, n: int, extra: dict | None = None) -> None:
        want = {**{k: n for k in names}, **(extra or {})}
        if self.windows[name] != want:
            raise RuntimeError(f"the {name} window launched {self.windows[name]}; expected {want}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms_per_call(fn, dev: torch.device, inner: int) -> float:
    "ms a call of `inner` calls of fn: CUDA events on the card, the host clock on the CPU."
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / inner
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    return (time.perf_counter() - t0) * 1e3 / inner


def measure(fn, dev: torch.device, sites: int, reps: int, inner: int):
    """One warm call, then `reps` windows of `inner` calls: (best Msites/s,
    [Msites/s of each rep], calls made)."""
    fn()
    _sync(dev)
    per_rep = [sites / _ms_per_call(fn, dev, inner) / 1e3 for _ in range(reps)]
    return max(per_rep), per_rep, 1 + reps * inner


def spread(per_rep: list) -> float:
    return (max(per_rep) - min(per_rep)) / max(per_rep)


def _normalized(a: torch.Tensor, b: torch.Tensor) -> float:
    "max |a - b| / max |b|: the gradient gate's measure."
    return float((a.double() - b).abs().max()) / (float(b.abs().max()) + 1e-12)


def gate(dev: torch.device, B: int = 8, S: int = 2, L: int = 1200, M: int = 16) -> dict:
    """The smc backend through `loss` (the kernels on the card, float32)
    against the plain float64 forward and adjoint of ops/smc.py on the same
    inputs and device: the ll and the gradient of every PSMCParams leaf."""
    data, pps, inds = workload(M, B, S, L, dev)
    kern = get_kernel(M, data, dev, backend="smc")
    leaves = [getattr(pps, k).requires_grad_() for k in PSMC_FIELDS]
    pp = PSMCParams(*(x[:, 0] for x in leaves[:6]), pi=leaves[6])
    ll = kern.loglik_batched(pp, inds)
    grads = torch.autograd.grad(ll.sum(), leaves)
    p64 = [x.detach().double() for x in leaves]
    params, pi, rows = tuple(x[:, 0] for x in p64[:6]), p64[6], kern.data[inds]
    ll_p, _, pstates = smc.forward_structured(params, pi, rows, True)
    g_p, dpi_p = smc.backward_structured(params, rows, pstates, torch.ones_like(ll_p),
                                         torch.zeros_like(pi))
    want = []
    for g in g_p:  # per instance (B, S, M): summed over chunks, at chunk 0 as `loss` reads it
        w = torch.zeros_like(pi)
        w[:, 0] = g.sum(1)
        want.append(w)
    want.append(dpi_p)
    e_ll = float(((ll.detach().double() - ll_p).abs() / ll_p.abs()).max())
    e_g = {k: _normalized(a, b) for k, a, b in zip(PSMC_FIELDS, grads, want)}
    ok = e_ll <= GATE_LL_RTOL and max(e_g.values()) <= GATE_GRAD
    return dict(shape=[B, S, L], M=M, max_rel_err_ll=e_ll, max_normalized_err_grad=e_g,
                limits=dict(ll_rel=GATE_LL_RTOL, grad_normalized=GATE_GRAD), ok=ok)


def smi(dev: torch.device, query: str, units: bool = True) -> list[str]:
    """The fields of `nvidia-smi --query-gpu=<query> --format=csv,noheader`
    (without units if not `units`) for the card of `dev`, named by its UUID."""
    uuid = torch.cuda.get_device_properties(dev).uuid
    cmd = ["nvidia-smi", f"--id=GPU-{uuid}", f"--query-gpu={query}",
           "--format=csv,noheader" + ("" if units else ",nounits")]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True).stdout
    return [x.strip() for x in out.strip().split(",")]


def clocks(dev: torch.device) -> tuple[float, float]:
    "(SM clock MHz, power draw W) of the card now."
    sm, draw = smi(dev, "clocks.sm,power.draw", units=False)
    return float(sm), float(draw)


def svgd_step(backend: str, overlap: int, dev: torch.device, chunks: np.ndarray,
              afs: np.ndarray, particles: int, counted: Launches, windows: int = 3,
              calls: int = 3, seed: int = 1) -> dict:
    """The JAX bench's training program on `backend`: the first call (the
    CUDA graph's warm-up and capture) timed apart, then the best of
    `windows` windows of `calls` calls, fenced, each call drawing its
    (steps_per_call, S) indices as mcmc.fit does."""
    gen = generators(seed, dev)[0]
    prog = build_training(chunks, afs, window_size=100, overlap=overlap, device=dev,
                          generator=gen, kernel_backend=backend,
                          options=dict(num_particles=particles, minibatch_size=5, niter=1000))
    k = prog.steps_per_call

    def call(state):
        inds = torch.randint(prog.N, (k, prog.S), generator=gen, device=dev)
        return prog.step(state, inds)[0]

    def first():
        t0 = time.perf_counter()
        state = call(prog.state)
        _sync(dev)
        return state, time.perf_counter() - t0

    def timed(state):
        best = float("inf")
        for _ in range(windows):
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(calls):
                state = call(state)
            _sync(dev)
            best = min(best, (time.perf_counter() - t0) / (calls * k))
        return best

    state, capture_s = counted.count(f"{backend}_svgd_first_call", first)
    best = counted.count(f"{backend}_svgd", lambda: timed(state))
    names = LAUNCHES[(backend, "fwd_grad", dev.type)]
    warm = 1 if dev.type == "cuda" else 0  # the capture's eager warm-up iteration
    for window, iters in (("first_call", warm + k), ("", windows * calls * k)):
        counted.check("_".join(filter(None, (backend, "svgd", window))), names,
                      SVGD_PASSES[backend] * iters, dict.fromkeys(ASSEMBLY[dev.type], iters))
    out = dict(ms_per_iter=best * 1e3, iters_per_sec=1.0 / best, steps_per_call=k,
               capture_s=capture_s)
    if backend == "smc":
        out.update(assembly_timing(prog, dev, counted))
    return out


def assembly_timing(prog, dev: torch.device, counted: Launches, reps: int = 3,
                    inner: int = 10) -> dict:
    """A1 and A2 alone on `prog`'s particles, AFS and transform: ms a launch,
    the best of `reps` windows of `inner` launches after a warm one."""
    x, init, afs, T = prog.state.particles.contiguous(), prog.init, prog.afs, prog.afs_transform
    leaves, l_prior, l_afs = assembly.forward(init, x, afs, T)
    g = (torch.ones_like(leaves), torch.ones_like(l_prior), torch.ones_like(l_afs))
    out = {}
    for what, fn, kernel in (
            ("fwd", lambda: assembly.forward(init, x, afs, T), ASSEMBLY[dev.type][0]),
            ("grad", lambda: assembly.backward(init, x, afs, T, *g), ASSEMBLY[dev.type][1])):
        def window(fn=fn):
            fn()
            _sync(dev)
            return min(_ms_per_call(fn, dev, inner) for _ in range(reps))

        out[f"assembly_{what}_ms"] = counted.count(f"assembly_{what}", window)
        counted.check(f"assembly_{what}", (kernel,), 1 + reps * inner)
    return out


def roofline_share(ms: float, kernels: tuple, M: int, B: int, S: int, L: int) -> tuple:
    """(share, bound_by of each kernel): the bound of a call that runs
    `kernels` once each over its measured `ms`; a share outside (0, 1]
    means a wrong count and fails the run."""
    bounds = {k: roofline.kernel_bound(k, M, B, S, L) for k in kernels}
    share = sum(b[0] for b in bounds.values()) / ms
    if not 0.0 < share <= 1.0:
        raise RuntimeError(f"roofline share {share} of {kernels} outside (0, 1]: "
                           f"the count is wrong ({bounds}, measured {ms} ms)")
    return share, {k: b[1] for k, b in bounds.items()}


def run(device="cuda", *, M: int = 16, B: int = 500, S: int = 5, L: int = 20_000,
        L_base: int = 1_000, alt_M: tuple = (32, 64), gate_shape: tuple = (8, 2, 1200),
        svgd_chunks: tuple = (2000, 2500), svgd_particles: int = 500, overlap: int = 500,
        inner: int = 10, reps: int = 3) -> dict:
    """The bench's line as a dict (see the module docstring); the shapes are
    keyword arguments, the defaults the JAX bench's.  `device="cuda"`
    raises where there is no card."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    card, limit = smi(dev, "name,power.limit") if on_card else (None, None)
    extra = dict(device=dev.type, kernel="cuda" if on_card else "plain", device_name=card,
                 power_limit=limit, torch=torch.__version__, cuda=torch.version.cuda)
    g = gate(dev, *gate_shape, M=M)
    extra["gate"] = g
    logger.info("gate at B, S, L = %s: ll %.3e, gradients %.3e (ok: %s)", gate_shape,
                g["max_rel_err_ll"], max(g["max_normalized_err_grad"].values()), g["ok"])
    if not g["ok"]:
        return dict(metric=METRIC, value=None, unit="Msites/sec", vs_baseline=None, extra=extra)

    counted = Launches()
    sample = []  # (SM clock MHz, power draw W) before and after the timed windows
    data, pps, inds = workload(M, B, S, L, dev)
    sites = B * S * L
    kern = get_kernel(M, data, dev, backend="smc")
    fwd_grad, fwd = passes(kern, pps, inds)
    fwd_grad()  # the first launches, before the clocks' first sample
    _sync(dev)
    if on_card:
        sample.append(clocks(dev))

    # the number of record, with at most one re-measure of a noisy window
    def both():
        f, f_reps, n_f = counted.count("fwd_only", lambda: measure(fwd, dev, sites, reps, inner))
        counted.check("fwd_only", LAUNCHES[("smc", "fwd_only", dev.type)], n_f)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        g_, g_reps, n_g = counted.count("fwd_grad",
                                        lambda: measure(fwd_grad, dev, sites, reps, inner))
        counted.check("fwd_grad", LAUNCHES[("smc", "fwd_grad", dev.type)], n_g)
        return f, f_reps, g_, g_reps

    ours_fwd, fwd_reps, ours, grad_reps = both()
    retries = 0
    if spread(grad_reps) >= NOISY:
        retries = 1
        logger.info("noisy window (rep spread %.3f); measuring again", spread(grad_reps))
        again = both()
        if spread(again[3]) < spread(grad_reps):
            ours_fwd, fwd_reps, ours, grad_reps = again
    peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6 if on_card else None

    # the scan baseline on the same device, at fewer sites
    base_kern = get_kernel(M, data[:, :L_base], dev, backend="scan")
    base, _, _ = counted.count("baseline", lambda: measure(
        passes(base_kern, pps, inds)[0], dev, B * S * L_base, reps, min(3, inner)))
    counted.check("baseline", (), 0)

    line = {"fwd_only_Msites_per_sec": ours_fwd, "baseline_fwd_grad_Msites_per_sec": base,
            "ours_L": L, "baseline_L": L_base, "fwd_grad_per_rep_Msites_per_sec": grad_reps,
            "fwd_per_rep_Msites_per_sec": fwd_reps, "rep_spread": spread(grad_reps),
            "device_health": "ok" if spread(grad_reps) < NOISY else "noisy",
            "noisy_window_retries": retries}

    for m in alt_M:
        data_m, pps_m, inds_m = workload(m, B, S, L, dev)
        kern_m = get_kernel(m, data_m, dev, backend="smc")
        g_m, f_m = passes(kern_m, pps_m, inds_m)
        for what, fn in (("fwd_grad", g_m), ("fwd_only", f_m)):
            name = f"m{m}_{what}"
            best, _, n = counted.count(name, lambda: measure(fn, dev, sites, min(2, reps), inner))
            counted.check(name, LAUNCHES[("smc", what, dev.type)], n)
            line[f"{name}_Msites_per_sec"] = best
        line[f"m{m}_backend"] = type(kern_m).__name__

    # the packed backend at M = 16 on the same inputs
    pkern = get_kernel(M, data, dev, backend="packed")
    for what, fn in zip(("fwd_grad", "fwd_only"), passes(pkern, pps, inds)):
        name = f"packed_{what}"
        best, _, n = counted.count(name, lambda: measure(fn, dev, sites, reps, inner))
        counted.check(name, LAUNCHES[("packed", what, dev.type)], n)
        line[f"{name}_Msites_per_sec"] = best

    # the SVGD step of each hand-kernel path
    rng2 = np.random.default_rng(1)
    chunks = rng2.binomial(1, 0.05, size=svgd_chunks).astype(np.int8)
    afs = rng2.integers(100, 1000, size=9).astype(np.int64)
    steps = {b: svgd_step(b, ov, dev, chunks, afs, svgd_particles, counted)
             for b, ov in (("smc", overlap), ("packed", 0))}
    if on_card:
        sample.append(clocks(dev))
    line.update(svgd_step_ms_per_iter=steps["smc"]["ms_per_iter"],
                svgd_iters_per_sec=steps["smc"]["iters_per_sec"],
                svgd_steps_per_call=steps["smc"]["steps_per_call"],
                svgd_capture_s=steps["smc"]["capture_s"],
                packed_svgd_step_ms_per_iter=steps["packed"]["ms_per_iter"],
                packed_svgd_capture_s=steps["packed"]["capture_s"],
                assembly_fwd_ms=steps["smc"]["assembly_fwd_ms"],
                assembly_grad_ms=steps["smc"]["assembly_grad_ms"],
                assembly_particles=svgd_particles)

    # roofline shares of the kernels' bound at this shape (roofline.py)
    for prefix, value, kernels in (
            ("", ours_fwd, ("smc_forward",)),
            ("", ours, ("smc_forward_residuals", "smc_backward")),
            ("packed_", line["packed_fwd_only_Msites_per_sec"], ("packed_forward",)),
            ("packed_", line["packed_fwd_grad_Msites_per_sec"],
             ("packed_forward_ckpt", "packed_backward"))):
        what = "fwd" if len(kernels) == 1 else "fwd_grad"
        share, by = (roofline_share(sites / value / 1e3, kernels, M, B, S, L) if on_card
                     else (None, None))
        line[f"{prefix}roofline_fraction_{what}"] = share
        line[f"{prefix}roofline_bound_by_{what}"] = by
    # the smc kernels' share of the issue ceiling and of the shuffle path
    # (roofline.issue_share), phlash_tpu's vpu_issue_peak_fraction_* on a TPU
    for what, value, kernels in (("fwd", ours_fwd, ("smc_forward",)),
                                 ("fwd_grad", ours, ("smc_forward_residuals", "smc_backward"))):
        for pipe in ("issue", "shuffle"):
            line[f"sm_{pipe}_peak_fraction_{what}"] = (
                roofline.issue_share(sites / value / 1e3, kernels, M, B, S, L, pipe)
                if on_card else None)
    line.update(clocks_sm_mhz=[s[0] for s in sample] if on_card else None,
                power_draw_w=[s[1] for s in sample] if on_card else None,
                peak_mem_MB=peak_mb, launches=counted.windows)
    return dict(metric=METRIC, value=ours, unit="Msites/sec", vs_baseline=ours / base,
                extra={**line, **extra})


def main(device="cuda", **shapes) -> int:
    """Print the line of run(device, **shapes) as one line of JSON; 1 when
    the gate failed (value null), else 0."""
    out = run(device, **shapes)
    print(json.dumps(out))
    return 0 if out["value"] is not None else 1
