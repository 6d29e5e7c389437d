"""Executable end-to-end walkthrough on the port: BCF -> fit -> plot -> confidence band.

The counterpart of docs/example.py for phlash_tpu_torch, step for step: the
same simulated contig, the same BCF, the same regions and the same fit
options; only the package differs.  It runs on the CUDA card, where the fit
goes through the hand kernels (the SMC' forward and adjoint, the assembly
and its gradient), and raises without one; the CPU, where the kernels'
plain PyTorch versions stand in, is used only when asked for.

What it shows, in order:

1. simulate a genome from the exact continuous-time SMC' process under a
   bottleneck demography (no real data needed for a demo);
2. write it as a standard BCF (phlash_tpu_torch ships its own BCF
   writer/reader, no htslib/pysam required) -- in real use, start at step 3
   with your file;
3. load it with ``phlash_tpu_torch.contig(path, samples=, region=)``;
4. ``fit()`` with the production options: a device mesh, checkpointing,
   and strided dispatch (steps_per_call);
5. plot the posterior and compute a simultaneous confidence band.

Run:    python docs/torch_example.py [output_dir] [--device cpu]

Before DONE it prints one `card:` line of JSON: the card's `nvidia-smi
--query-gpu=name,power.limit` ("cpu" on the CPU), the fit's kernel launches
by ops module (ops/smc.py, ops/packed.py, ops/assembly.py, ops/svgd.py counts), and the
band's grid size and least upper - lower Ne(t).  The iterations the fit ran
are the checkpoint's step.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import phlash_tpu_torch  # noqa: E402
from phlash_tpu_torch.cband import confidence_band  # noqa: E402
from phlash_tpu_torch.io.bcf import write_bcf  # noqa: E402
from phlash_tpu_torch.kernel import resolve_device  # noqa: E402
from phlash_tpu_torch.ops import assembly, packed, smc, svgd  # noqa: E402
from phlash_tpu_torch.parallel import make_mesh  # noqa: E402
from phlash_tpu_torch.sim import bottleneck_demography, simulate_smc_continuous  # noqa: E402

WINDOW = 100  # bp per het-matrix column
COUNTED = {"smc": smc, "packed": packed, "assembly": assembly, "svgd": svgd}  # launch counters


def simulate_to_bcf(path: str, L_windows: int = 150_000, seed: int = 1):
    """Steps 1-2: draw a diploid contig and write it as an indexed BCF.

    A window with >= 1 heterozygous call becomes one het variant record at
    the window's midpoint; everything else is homozygous reference (the
    walkthrough keeps the masking story out of scope).
    """
    truth = bottleneck_demography(theta=1e-2)
    contig = simulate_smc_continuous(truth, L=L_windows, seed=seed, window_size=WINDOW)
    het = np.asarray(contig.het_matrix[0])
    span = L_windows * WINDOW
    header = "\n".join(
        [
            "##fileformat=VCFv4.2",
            '##FILTER=<ID=PASS,Description="All filters passed">',
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
            f"##contig=<ID=chr1,length={span}>",
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample1",
        ]
    )
    records = [
        ("chr1", int(w) * WINDOW + WINDOW // 2, "A", ["T"], [(0, 1)])
        for w in np.flatnonzero(het == 1)
    ]
    write_bcf(path, header, records, index=True)
    return truth, span


def load(bcf_path: str, span: int):
    "Step 3: the training contig (the first 4/5 of the span) and the held-out rest."
    # samples= and region= are required for VCF/BCF, exactly as in the
    # reference API (a guard against silently analyzing telomeres)
    train = phlash_tpu_torch.contig(bcf_path, samples=["sample1"],
                                    region=f"chr1:1-{span * 4 // 5}")
    held_out = phlash_tpu_torch.contig(bcf_path, samples=["sample1"],
                                       region=f"chr1:{span * 4 // 5 + 1}-{span}")
    return train, held_out


def card_name(dev: torch.device) -> str:
    "The card's nvidia-smi name and power limit, or 'cpu'."
    if dev.type != "cuda":
        return "cpu"
    from phlash_tpu_torch.bench import smi

    return ", ".join(smi(dev, "name,power.limit"))


def main(outdir: str = None, device: str = "cuda", L_windows: int = 150_000,
         chunk_size: int = 5000, niter: int = 40, num_particles: int = 32):
    dev = resolve_device(device)  # no card: raises here, before any work
    outdir = outdir or tempfile.mkdtemp(prefix="phlash_tpu_torch_example_")
    os.makedirs(outdir, exist_ok=True)
    bcf_path = os.path.join(outdir, "example.bcf")

    print(f"1-2. simulating a {L_windows * WINDOW / 1e6:g} Mb diploid contig and writing",
          bcf_path)
    truth, span = simulate_to_bcf(bcf_path, L_windows)

    print("3.   loading the contig")
    train, held_out = load(bcf_path, span)

    # 4. fit.  The options shown are the production set:
    #    mesh=            shard particles/data over every attached device
    #    checkpoint_path= resume an interrupted run from the last save
    #    steps_per_call=  chain SVGD iterations inside one dispatch (a CUDA graph)
    #    test_data=       held-out ELPD early stopping
    print(f"4.   fitting (small run: {niter} iterations, {num_particles} particles)")
    for mod in COUNTED.values():
        mod.reset_counts()
    own_group = not dist.is_initialized()  # make_mesh makes a one-rank world if none
    posterior = phlash_tpu_torch.fit(
        [train],
        test_data=held_out,
        device=dev,
        mesh=make_mesh(device_type=dev.type),
        checkpoint_path=os.path.join(outdir, "fit_ckpt.npz"),
        steps_per_call=5,
        niter=niter,
        num_particles=num_particles,
        overlap=100,
        chunk_size=chunk_size,
        num_workers=1,
        elpd_cutoff=30,
        progress=False,
    )
    launches = {name: mod.counts() for name, mod in COUNTED.items()}
    if own_group:
        dist.destroy_process_group()
    print(f"     posterior: {len(posterior)} DemographicModel samples")

    # 5a. static plot of the posterior Ne(t) band
    fig_path = os.path.join(outdir, "posterior.png")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        phlash_tpu_torch.plot_posterior(posterior, ax=ax)
        fig.savefig(fig_path, dpi=100)
        print("5a.  wrote", fig_path)
    except ImportError:
        print("5a.  matplotlib not available; skipping the figure")

    # 5b. simultaneous 95% confidence band on Ne(t) (MILP, scipy/HiGHS).
    # lo/hi bound Ne(t) = 1/(2 c(t)): evaluate with Ne=True to compare.
    lo, hi = confidence_band(posterior)
    t = lo.t.numpy()
    gap = hi(t, Ne=True).numpy() - lo(t, Ne=True).numpy()
    assert np.all(gap >= -1e-9)
    print("5b.  confidence band: lower/upper Ne(t) over", len(t), "grid points")

    # sanity: the posterior median coalescence scale should bracket the
    # truth's order of magnitude even in this tiny demo run
    med_c = float(np.median(torch.cat([dm.eta.c for dm in posterior]).cpu().numpy()))
    print(f"     posterior median c = {med_c:.3f} (truth is O(1))")
    print("card: " + json.dumps(dict(card=card_name(dev), launches=launches,
                                     band_points=len(t), band_min_gap=float(gap.min()))))
    print("DONE:", outdir)
    return outdir


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", default=None, help="output directory (default: a new "
                    "temporary one)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    main(args.outdir, device=args.device)
