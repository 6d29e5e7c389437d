"""Write the phlash_tpu.fit posteriors that phlash_tpu_torch is held against.

Simulates the dataset of tools/posterior_repro.py (two contigs of 6,000,000
windows from the continuous SMC' process under bottleneck_demography(theta
= 1e-2), seeds 0 and 1, one diploid sample each), then runs phlash_tpu.fit
on the CPU with that script's shared options (48 particles, 250
iterations, S = 5, learning rate 0.1, sigma 1, theta 1e-4, t1 1e-3, tM 15),
window_size 100, chunk_size 2000, no held-out data and the dense kernel
backend (phlash_tpu's default off the TPU), once for each key of KEYS and
each overlap:

* overlap 500, the counterpart of the port's kernel_backend="smc";
* overlap 0, the counterpart of kernel_backend="packed".

One fit's posterior median moves with its key by about as much as the
North star's gates allow, so the fixture is an ensemble: the fits of all
keys of one overlap, pooled in key order (len(KEYS) x 48 particles),
written with phlash_tpu.results.save_posterior to
tests/data/torch_posterior_overlap{500,0}.npz.  Beside them
torch_posterior_fixture.json records the options, seeds, keys, commit and
wall times.  phlash_tpu_torch.sim regenerates the identical dataset from
the same seeds, so only the posteriors are committed (chip_smoke.py phase 6
fits the same ensemble on the card and compares with
phlash_tpu_torch.repro).

Usage:  JAX_PLATFORMS=cpu python tools/torch_posterior_fixture.py [--workers N]
(each fit takes ~100-160 s of one process; --workers runs fits in parallel
processes, 8 by default).
"""

from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# CPU by design; an ambient accelerator plugin can override JAX_PLATFORMS from
# the environment, so the platform is pinned in-process before the first use
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# the dataset and options of tools/posterior_repro.py:207-230
TRUTH_THETA = 1e-2
L = 6_000_000
SEEDS = (0, 1)
WINDOW_SIZE, CHUNK_SIZE = 100, 2000
SHARED = dict(niter=250, num_particles=48, minibatch_size=5, learning_rate=0.1, sigma=1.0,
              theta=1e-4, t1=1e-3, tM=15.0)
KEYS = tuple(range(7, 23))  # one fit per key; the port's fits take these as seeds
JAX_BACKEND = "dense"  # phlash_tpu's default off the TPU, named so that any host runs the same
OVERLAPS = {500: "smc", 0: "packed"}  # overlap -> the port's kernel path it stands for


@functools.lru_cache(maxsize=1)
def _contigs():
    from phlash_tpu.sim import bottleneck_demography, simulate_smc_continuous

    truth = bottleneck_demography(theta=TRUTH_THETA)
    return [simulate_smc_continuous(truth, L=L, seed=s, n_samples=1) for s in SEEDS]


def fit_one(overlap: int, key: int):
    "(the posterior as numpy-backed DemographicModels, wall seconds) of one fit."
    import numpy as np

    import phlash_tpu
    from phlash_tpu.size_history import DemographicModel, SizeHistory

    contigs = _contigs()
    t0 = time.time()
    post = phlash_tpu.fit(contigs, test_data=None, window_size=WINDOW_SIZE, overlap=overlap,
                          chunk_size=CHUNK_SIZE, num_workers=1, progress=False,
                          kernel_backend=JAX_BACKEND, key=jax.random.PRNGKey(key), **SHARED)
    wall = time.time() - t0
    return [DemographicModel(eta=SizeHistory(t=np.asarray(dm.eta.t), c=np.asarray(dm.eta.c)),
                             theta=float(dm.theta), rho=float(dm.rho)) for dm in post], wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "tests" / "data"), help="output directory")
    ap.add_argument("--workers", type=int, default=8, help="fits run in parallel processes")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    from phlash_tpu.results import save_posterior

    t0 = time.time()
    contigs = _contigs()
    sim_s = time.time() - t0
    print(f"simulated {len(contigs)} contigs of {L} windows in {sim_s:.1f} s; het share "
          f"{[float((c.het_matrix == 1).mean()) for c in contigs]}")
    record = dict(truth=f"bottleneck_demography(theta={TRUTH_THETA})", L=L, seeds=list(SEEDS),
                  n_samples=1, window_size=WINDOW_SIZE, chunk_size=CHUNK_SIZE, test_data=None,
                  keys=list(KEYS), shared=SHARED, kernel_backend=JAX_BACKEND,
                  jax=jax.__version__, simulate_seconds=sim_s, fits={})
    try:
        record["commit"] = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                          capture_output=True, text=True).stdout.strip()
    except OSError:
        record["commit"] = None
    jobs = [(overlap, key) for overlap in OVERLAPS for key in KEYS]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=args.workers, mp_context=ctx) as pool:
        futures = {job: pool.submit(fit_one, *job) for job in jobs}
        done = {job: f.result() for job, f in futures.items()}
    for overlap, path_name in OVERLAPS.items():
        post = [dm for key in KEYS for dm in done[(overlap, key)][0]]
        name = f"torch_posterior_overlap{overlap}.npz"
        save_posterior(str(out / name), post)
        walls = [done[(overlap, key)][1] for key in KEYS]
        record["fits"][name] = dict(overlap=overlap, torch_kernel_backend=path_name,
                                    particles=len(post), wall_seconds=walls)
        print(f"overlap {overlap}: {len(KEYS)} fits, {len(post)} particles, "
              f"{min(walls):.1f}-{max(walls):.1f} s a fit -> {out / name}")
    with open(out / "torch_posterior_fixture.json", "w") as f:
        json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
