#!/usr/bin/env python3
"""Posterior recovery against the truth on one card: the counterpart of tools/validate.py.

    python tools/torch_validate.py [--quick] [--simulator continuous|hmm] [--n-samples N]
    python tools/torch_validate.py --device cpu --L 4000 --niter 4 --particles 8  # small, CPU

For each test demography (sim.constant_demography, bottleneck_demography,
zigzag_demography, theta 1e-2), simulates three training contigs (seeds 0,
1, 2) and a held-out contig (seed 99) of L windows, from the exact
continuous-time SMC' process (the default; sim.simulate_smc_continuous,
bitwise equal to phlash_tpu.sim's on the same model) or from the
discretized HMM (--simulator hmm; sim.simulate_hmm on the device), fits the
posterior with phlash_tpu_torch.fit at tools/validate.py's options (500
particles, theta 1e-4, t1 1e-3, tM 15, alpha 1, minibatch 5, ELPD early
stopping after max(50, niter // 4) iterations without a gain, seed 7), and
reports, on the host in float64 (`metrics`):

* the total-variation distance between the posterior-median model's
  coalescence density and the truth's (SizeHistory.tv);
* the fraction of a 64-point geometric grid between the truth's 5% and 95%
  coalescence-time quantiles where the true Ne lies inside the posterior's
  95% band.

Sizes: L = 500,000 windows and 300 iterations, or 100,000 and 100 with
--quick; --L, --niter and --particles override them (to run on the CPU).
Prints tools/validate.py's line for each demography with the iterations
the fit ran, its wall time and the card's name and power limit; then one
JSON line with each demography's numbers (its hand-kernel launches by ops
module, its tv against the other demographies' truths); then the line
`SUMMARY worst tv=`.  Exits 0 only if the worst tv is under 0.25.  Writes
validation_<name>.png per demography to --plot-dir when matplotlib
imports, and says so when it does not.  Runs on the card unless --device
cpu is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from phlash_tpu_torch import repro, sim  # noqa: E402
from phlash_tpu_torch.size_history import DemographicModel, SizeHistory  # noqa: E402

THETA = 1e-2  # the demographies' scaled mutation rate a window
DEMOGRAPHIES = {"constant": sim.constant_demography, "bottleneck": sim.bottleneck_demography,
                "zigzag": sim.zigzag_demography}
TRAIN_SEEDS, TEST_SEED = (0, 1, 2), 99
# tools/validate.py's fit options (key=PRNGKey(7) there, seed 7 here)
FIT_OPTIONS = dict(theta=1e-4, t1=1e-3, tM=15.0, alpha=1.0, minibatch_size=5)
FIT_SEED = 7
GRID_POINTS = 64
TV_GATE = 0.25  # exit 0 only if every demography's tv is under it


def truths() -> dict[str, DemographicModel]:
    "The three test demographies at theta 1e-2, by name."
    return {name: make(theta=THETA) for name, make in DEMOGRAPHIES.items()}


def datasets(truth: DemographicModel, L: int, simulator: str = "continuous", n_samples: int = 1,
             device="cpu"):
    """(training contigs, held-out contig) of L windows from `truth`: seeds
    TRAIN_SEEDS and TEST_SEED.  continuous: n_samples independent diploid
    rows a contig (no AFS when n_samples > 1); hmm: one row, drawn on
    `device`."""
    if simulator == "continuous":
        def draw(seed):
            return sim.simulate_smc_continuous(truth, L=L, seed=seed, n_samples=n_samples)
    else:
        def draw(seed):
            return sim.simulate_hmm(truth, L=L, seed=seed, device=device)
    return [draw(s) for s in TRAIN_SEEDS], draw(TEST_SEED)


def median_history(med: np.ndarray, grid: np.ndarray) -> SizeHistory:
    """The posterior-median Ne on `grid` as tools/validate.py builds it,
    SizeHistory(t=grid, c=1 / (2 med)), read as phlash_tpu reads it: before
    grid[0] jnp's index -1 wraps to the last point's rate, where this
    package's SizeHistory would clamp to the first.  So the history here
    starts at 0 with the last point's rate; tv's union grid starts at the
    truth's 0 either way, and the tv is the JAX tool's."""
    c = 1.0 / (2.0 * med)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    return SizeHistory(t=as_t(np.insert(grid, 0, 0.0)), c=as_t(np.insert(c, 0, c[-1])))


def metrics(post: list[DemographicModel], truth: DemographicModel) -> dict:
    """tools/validate.py:78-88 on the host in float64: the grid (GRID_POINTS
    geometric points between the truth's 5% and 95% coalescence-time
    quantiles), the posterior's 2.5 / 50 / 97.5% Ne on it (lo, med, hi),
    the true Ne, the band's coverage of it, the median as a SizeHistory
    (`median_history`) and its tv against the truth; also
    tv_first_rate_back, the tv of the median extended back to 0 with its
    first point's rate (repro.median_history), which the JAX tool does not
    compute."""
    grid = np.geomspace(truth.eta.quantile(0.05), truth.eta.quantile(0.95), GRID_POINTS)
    lo, med, hi = np.quantile(repro.ne_curves(post, grid), [0.025, 0.5, 0.975], axis=0)
    true_ne = truth.eta(torch.as_tensor(grid, dtype=torch.float64), Ne=True).numpy()
    med_eta = median_history(med, grid)
    return dict(grid=grid, lo=lo, med=med, hi=hi, true_ne=true_ne, med_eta=med_eta,
                coverage=float(((true_ne >= lo) & (true_ne <= hi)).mean()),
                tv=float(truth.eta.tv(med_eta)),
                tv_first_rate_back=float(truth.eta.tv(repro.median_history(med, grid))))


class _Meter(logging.Handler):
    "Keeps the StepMeter of fit's 'fit finished' record."

    def __init__(self):
        super().__init__(logging.INFO)
        self.meter = None

    def emit(self, record):
        if hasattr(record, "step_meter"):
            self.meter = record.step_meter


def plot(path: str, name: str, m: dict) -> None:
    "tools/validate.py's figure of the band, the median and the truth."
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.fill_between(m["grid"], m["lo"], m["hi"], alpha=0.25, label="posterior 95%")
    ax.plot(m["grid"], m["med"], label="posterior median")
    ax.plot(m["grid"], m["true_ne"], "k--", label="truth")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("time (coalescent units)")
    ax.set_ylabel("Ne")
    ax.set_title(name)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def run(name: str, truth: DemographicModel, args, dev: torch.device, card: str) -> dict:
    "Simulate, fit and evaluate one demography; print its line."
    from phlash_tpu_torch.mcmc import fit
    from phlash_tpu_torch.ops import assembly, packed, smc, svgd

    mods = {"smc": smc, "packed": packed, "assembly": assembly, "svgd": svgd}
    t0 = time.perf_counter()
    contigs, test = datasets(truth, args.L, args.simulator, args.n_samples, dev)
    simulate_s = time.perf_counter() - t0
    for mod in mods.values():
        mod.reset_counts()
    log = logging.getLogger("phlash_tpu_torch.mcmc")
    meter, level = _Meter(), log.level
    log.addHandler(meter)
    log.setLevel(logging.INFO)
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        post = fit(contigs, test_data=test, device=dev, seed=FIT_SEED, niter=args.niter,
                   num_particles=args.particles, num_workers=1, progress=False,
                   elpd_cutoff=max(50, args.niter // 4), **FIT_OPTIONS)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        log.removeHandler(meter)
        log.setLevel(level)
    m = metrics(post, truth)
    finite = all(bool(torch.isfinite(d.eta.c).all() and torch.isfinite(d.eta.t).all())
                 for d in post)
    iters = meter.meter.steps
    print(f"{name}: tv(median, truth) = {m['tv']:.3f}, 95%-band coverage = {m['coverage']:.2f}, "
          f"{len(post)} samples, wall {wall:.0f}s; {iters} iterations run (of {args.niter}); "
          f"{card}", flush=True)
    return dict(name=name, tv=m["tv"], coverage=m["coverage"],
                tv_first_rate_back=m["tv_first_rate_back"], samples=len(post), finite=finite,
                iterations=iters, niter=args.niter, wall_s=wall,
                graph_setup_s=meter.meter.setup_seconds, simulate_s=simulate_s,
                launches={k: mod.counts() for k, mod in mods.items()}, metrics=m)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="small sizes for smoke testing")
    ap.add_argument("--simulator", choices=["continuous", "hmm"], default="continuous",
                    help="continuous = exact SMC' process (non-circular, default); "
                         "hmm = the discretized HMM the likelihood assumes")
    ap.add_argument("--n-samples", type=int, default=1,
                    help="diploid samples per contig (continuous simulator only); "
                         ">1 validates the multi-sample composite-likelihood path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--L", type=int, default=None,
                    help="windows a contig (default 500,000; 100,000 with --quick)")
    ap.add_argument("--niter", type=int, default=None,
                    help="SVGD iterations (default 300; 100 with --quick)")
    ap.add_argument("--particles", type=int, default=500)
    ap.add_argument("--plot-dir", default=os.path.join(ROOT, "validation_plots"),
                    help="where validation_<name>.png go (default: validation_plots/, ignored)")
    args = ap.parse_args(argv)
    if args.L is None:
        args.L = 100_000 if args.quick else 500_000
    if args.niter is None:
        args.niter = 100 if args.quick else 300
    return args


def main(argv=None) -> int:
    from phlash_tpu_torch.kernel import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from phlash_tpu_torch.bench import smi

        card = ", ".join(smi(dev, "name,power.limit"))
    else:
        card = "cpu"
    suffix = "" if args.n_samples == 1 else f"_n{args.n_samples}"
    models = truths()
    results = [run(name + suffix, truth, args, dev, card) for name, truth in models.items()]

    for r, own in zip(results, models):
        r["tv_other_truths"] = {other: float(t.eta.tv(r["metrics"]["med_eta"]))
                                for other, t in models.items() if other != own}
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"plots: none written to {args.plot_dir} (matplotlib is not installed)")
    else:
        os.makedirs(args.plot_dir, exist_ok=True)
        for r in results:
            plot(os.path.join(args.plot_dir, f"validation_{r['name']}.png"), r["name"],
                 r["metrics"])
        print(f"plots: wrote {len(results)} to {args.plot_dir}")
    worst_tv = max(r["tv"] for r in results)
    print(json.dumps(dict(simulator=args.simulator, n_samples=args.n_samples, L=args.L,
                          niter=args.niter, particles=args.particles,
                          device=str(dev), card=card, worst_tv=worst_tv, tv_gate=TV_GATE,
                          demographies=[{k: v for k, v in r.items() if k != "metrics"}
                                        for r in results])))
    print(f"SUMMARY worst tv={worst_tv:.3f}")
    return 0 if worst_tv < TV_GATE else 1


if __name__ == "__main__":
    sys.exit(main())
