"""How far apart are two phlash_tpu.fit posteriors of the same data?

The committed fixture (tests/data/torch_posterior_overlap{500,0}.npz,
written by tools/torch_posterior_fixture.py) pools the fits of 16 keys, 48
particles each, in key order.  This script splits it back into its fits and
runs repro.compare (the North star's gates: tv of the medians <= 0.10,
mutual 95%-band coverage >= 0.90) on random pairs of single fits and on
random disjoint ensembles of K fits a side, printing for each K the share
of comparisons that pass and the spread of tv and coverage.  It is the null
distribution of chip_smoke.py phase 6, which compares the port's ensemble
of 16 fits with this one: a gate between single fits would measure the
seed.  Last, for each fixture, the gates' reading on planted biases
(repro.planted): the 16 fits against themselves, and the share of 8-fit
ensembles against 8 others that still pass.  No JAX is imported.

Usage:  python tools/torch_posterior_spread.py [--draws 40] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from phlash_tpu_torch import repro, results, sim  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=40, help="random comparisons for each K")
    ap.add_argument("--seed", type=int, default=0, help="seed of the draws")
    args = ap.parse_args()
    data = ROOT / "tests" / "data"
    meta = json.loads((data / "torch_posterior_fixture.json").read_text())
    P, keys = meta["shared"]["num_particles"], meta["keys"]
    truth = sim.bottleneck_demography(theta=1e-2)
    rng = np.random.default_rng(args.seed)
    plant_rng = np.random.default_rng([args.seed, 1])  # leaves rng's draws as they were
    for name, fit in meta["fits"].items():
        pooled = results.load_posterior(str(data / name))
        fits = [pooled[i * P: (i + 1) * P] for i in range(len(keys))]
        for K in (1, 2, 4, 8):
            rows = []
            for _ in range(args.draws):
                order = rng.permutation(len(fits))
                a = [m for i in order[:K] for m in fits[i]]
                b = [m for i in order[K: 2 * K] for m in fits[i]]
                r = repro.compare(a, b, truth)
                rows.append((r["tv_cross"], min(r["cover_ours_in_ref"], r["cover_ref_in_ours"]),
                             r["ok"]))
            tv, cover, ok = (np.array(x, dtype=float) for x in zip(*rows))
            print(json.dumps(dict(fixture=name, overlap=fit["overlap"], fits_a_side=K,
                                  draws=args.draws, pass_share=float(ok.mean()),
                                  tv_median=float(np.median(tv)),
                                  tv_p90=float(np.quantile(tv, 0.9)), tv_max=float(tv.max()),
                                  min_cover_median=float(np.median(cover)),
                                  min_cover_min=float(cover.min()))))
        # the gates' power: planted biases on all 16 fits against themselves
        # (no seed spread), and on 8 fits against 8 others
        halves = [repro.planted([m for i in order[:8] for m in fits[i]],
                                [m for i in order[8:16] for m in fits[i]], truth)
                  for order in (plant_rng.permutation(len(fits)) for _ in range(args.draws))]
        print(json.dumps(dict(
            fixture=name, overlap=fit["overlap"], planted_epochs=[repro.PLANT_EPOCHS.start,
                                                                  repro.PLANT_EPOCHS.stop],
            planted_16_against_itself=repro.planted(pooled, pooled, truth),
            planted_8_against_8_pass_share={f: float(np.mean([h[f]["ok"] for h in halves]))
                                            for f in halves[0]})))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
