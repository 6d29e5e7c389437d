"""Command line: `python -m phlash_tpu_torch fit ...` (or `phlash-tpu-torch fit ...`).

Port of phlash_tpu/__main__.py:16-98: fit from .psmcfa / .vcf(.gz) / .bcf /
tree-sequence inputs, save the posterior, optionally plot it.  The flags are
phlash_tpu's, plus --device (default cuda; cpu for a run without a card);
--seed seeds the fit.  Each VCF / BCF input takes the next --region in
order, so two regions of one file are read by naming the file twice.
`bench` (phlash_tpu/__main__.py:60-66 runs the JAX bench.py) runs the
port's own measurement, bench.py in this package, and prints its one JSON
line; it takes --device (default cuda) and no shape flags.
"""

from __future__ import annotations

import argparse
import logging
import sys

VCF_SUFFIXES = (".vcf", ".vcf.gz", ".bcf")


def _add_fit(sub):
    p = sub.add_parser("fit", help="sample the posterior size history from genome data")
    p.add_argument("inputs", nargs="+", help=".psmcfa/.vcf/.vcf.gz/.bcf/.trees/.tsz files")
    p.add_argument("--samples", nargs="*", default=None, help="sample ids (VCF)")
    p.add_argument("--region", action="append", default=None,
                   help='VCF region per input, e.g. "chr1:1-100000000"')
    p.add_argument("--mutation-rate", type=float, default=None)
    p.add_argument("--niter", type=int, default=1000)
    p.add_argument("--particles", type=int, default=500)
    p.add_argument("--window-size", type=int, default=100)
    p.add_argument("--hold-out", action="store_true",
                   help="reserve the first contig for ELPD early stopping")
    p.add_argument("--checkpoint", default=None, help="checkpoint path (resumable)")
    p.add_argument("--out", default="posterior.npz")
    p.add_argument("--plot", default=None, help="write a posterior plot PNG here")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda", help='torch device: "cuda" (default) or "cpu"')
    return p


def _add_bench(sub):
    p = sub.add_parser("bench", help="time the hand kernels and the SVGD step; one JSON line")
    p.add_argument("--device", default="cuda",
                   help='torch device: "cuda" (default) or "cpu" (the plain versions)')
    return p


def _load_contigs(args):
    from phlash_tpu_torch.data import RawContig, contig

    contigs = []
    regions = list(args.region or [])
    for src in args.inputs:
        if src.endswith(".psmcfa") or src.endswith(".psmcfa.gz"):
            contigs.extend(RawContig.from_psmcfa_iter(src, args.window_size))
        elif src.endswith(VCF_SUFFIXES):
            if not regions:
                raise SystemExit(f"--region required for VCF input {src}")
            contigs.append(contig(src, samples=args.samples, region=regions.pop(0)))
        else:
            contigs.append(contig(src, samples=args.samples))
    return contigs


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(prog="phlash_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_fit(sub)
    _add_bench(sub)
    args = ap.parse_args(argv)
    if args.cmd == "bench":
        from phlash_tpu_torch.bench import main as bench

        return bench(device=args.device)

    from phlash_tpu_torch.mcmc import fit
    from phlash_tpu_torch.results import save_posterior

    contigs = _load_contigs(args)
    test = contigs.pop(0) if args.hold_out and len(contigs) > 1 else None
    posterior = fit(
        contigs,
        test_data=test,
        niter=args.niter,
        num_particles=args.particles,
        window_size=args.window_size,
        mutation_rate=args.mutation_rate,
        checkpoint_path=args.checkpoint,
        device=args.device,
        seed=args.seed,
    )
    save_posterior(args.out, posterior)
    print(f"wrote {len(posterior)} posterior samples to {args.out}")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from phlash_tpu_torch.plot import plot_posterior

        fig, ax = plt.subplots()
        plot_posterior(posterior, ax=ax)
        fig.savefig(args.plot, dpi=150)
        plt.close(fig)
        print(f"wrote {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
