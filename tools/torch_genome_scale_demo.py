#!/usr/bin/env python3
"""Whole-genome ingestion and fit on one card: the counterpart of tools/genome_scale_demo.py.

    python tools/torch_genome_scale_demo.py [--holdout] [--scale 1.0] [--device cuda]
    python tools/torch_genome_scale_demo.py --scale 0.0005 --device cpu --particles 8 \\
        --niter 2 --holdout       # a small run on the CPU

Synthesizes a whole-genome single-diploid VCF (22 chromosomes of
CHROM_MB, 2.87 Gbp of coordinates at --scale 1, ~1 het/kb, one .vcf.gz a
chromosome, from --seed), stream-ingests it through phlash_tpu_torch.contig
(the C tokenizer) and init_mcmc_data in a spawn pool of 8 into chunks of
--chunk-size + --overlap windows of --window bp, builds the training
program on the WHOLE chunk tensor (training.build_training: every chunk
resident on the device, where fit would cap it at what a short run visits),
and runs --niter SVGD iterations of the fit default (pattern 14*1+1*2,
M = 16, float32, the smc kernels, S = 5) through training.Caller: on CUDA,
graph replays of steps_per_call = 10 iterations.  With --holdout, chr22 is
held out: a plain call against an ELPD-bearing call (mcmc.held_out_elpd,
fused by Caller as fit fuses it), by graph replay, gives the held-out
ELPD's overhead on the fit at the 10-iteration cadence.

Prints one line a stage (synthesis; ingestion with this process's peak
RSS through both, read after ingestion, before torch is imported; upload,
build and first call; ms an iteration; peak device memory; the posterior
median of c[0]; the ELPD overhead), and as its last line one JSON object
with those numbers, the kernel launch counts of the fit, of the timing of
plain calls and of the hold-out timing (ops/smc, ops/packed, ops/assembly
and ops/svgd's counts, by stage), the calls each made, and the card's name
and power limit.  "ms an iteration" is the best of REPS runs of INNER
calls from the fitted state, after the fit; on CUDA, graph replays.  The
spawn pool needs this file's `if __name__ == "__main__"` guard.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

CHROM_MB = [248, 242, 198, 190, 182, 171, 159, 145, 138, 134,
            135, 133, 114, 107, 102, 90, 83, 80, 59, 64, 47, 51]  # ~3.07 Gbp
SAMPLE = "NA00001"
WORKERS = 8  # the ingestion pool
REPS, INNER = 3, 5  # the timings: best of REPS runs of INNER calls


def rss_gb() -> float:
    "This process's resident set size now, in GB (/proc/self/statm)."
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


@contextlib.contextmanager
def peak_rss(every: float = 0.005):
    """Yields a list whose one entry becomes the largest rss_gb() sampled
    every `every` seconds while the block runs.  Sampled, because
    ru_maxrss keeps across exec the peak of the process that started this
    one, and not every kernel's /proc has VmHWM."""
    peak, done = [rss_gb()], threading.Event()

    def sample():
        while not done.wait(every):
            peak[0] = max(peak[0], rss_gb())

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield peak
    finally:
        done.set()
        thread.join()
        peak[0] = max(peak[0], rss_gb())


def synth_chromosome(path: str, chrom: str, length: int, rng: np.random.Generator,
                     het_per_bp: float = 1e-3) -> int:
    "Write a sorted single-diploid VCF with Poisson het sites; returns #records."
    n = rng.poisson(het_per_bp * length)
    pos = np.sort(rng.choice(length, size=n, replace=False)) + 1
    # mix of het (0/1) and hom-alt (1/1) calls plus a few missing
    kind = rng.choice(3, size=n, p=[0.85, 0.12, 0.03])
    gt = np.array(["0/1", "1/1", "./."])[kind]
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##contig=<ID={chrom},length={length}>\n")
        f.write(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{SAMPLE}\n")
        rows = "\n".join(
            f"{chrom}\t{p}\t.\tA\tT\t.\tPASS\t.\tGT\t{g}" for p, g in zip(pos, gt)
        )
        f.write(rows + "\n")
    return int(n)


def synthesize(tdir: str, scale: float, seed: int) -> list[tuple[str, str, int]]:
    "The 22 chromosomes' VCFs in tdir, one generator drawn in turn: [(path, name, length)]."
    rng = np.random.default_rng(seed)
    paths = []
    for i, mb in enumerate(CHROM_MB, 1):
        length = int(mb * 1e6 * scale)
        path = os.path.join(tdir, f"chr{i}.vcf.gz")
        synth_chromosome(path, f"chr{i}", length, rng)
        paths.append((path, f"chr{i}", length))
    return paths


def ingest(paths, window: int, overlap: int, chunk_size: int, num_workers: int):
    "(AFS, int8 chunks) of the VCFs through phlash_tpu_torch's reader and init_mcmc_data."
    from phlash_tpu_torch.data import contig, init_mcmc_data

    contigs = [contig(p, samples=[SAMPLE], region=f"{c}:1-{L}") for p, c, L in paths]
    return init_mcmc_data(contigs, window_size=window, overlap=overlap, chunk_size=chunk_size,
                          num_workers=num_workers)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0, help="genome size multiplier")
    ap.add_argument("--niter", type=int, default=30)
    ap.add_argument("--window", type=int, default=100)
    ap.add_argument("--chunk-size", type=int, default=500, help="windows per chunk")
    ap.add_argument("--overlap", type=int, default=100)
    ap.add_argument("--particles", type=int, default=500)
    ap.add_argument("--holdout", action="store_true",
                    help="hold out chr22 and measure the fused held-out ELPD's overhead "
                         "(an ELPD-bearing call against a plain call at the 10-iteration "
                         "cadence)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seeds the VCFs, the cloud and the draws")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = {"scale": args.scale, "seed": args.seed}

    with tempfile.TemporaryDirectory(prefix="phlash_genome_") as tdir:
        with peak_rss() as peak:
            t0 = time.perf_counter()
            paths = synthesize(tdir, args.scale, args.seed)
            out["synth_s"] = time.perf_counter() - t0
            out["gbp"] = sum(L for _, _, L in paths) / 1e9
            out["vcf_mb"] = sum(os.path.getsize(p) for p, _, _ in paths) / 1e6
            print(f"synthesis: {out['gbp']:.3f} Gbp across {len(paths)} chromosomes "
                  f"({out['vcf_mb']:.1f} MB gz) in {out['synth_s']:.2f} s", flush=True)

            holdout = paths.pop() if args.holdout else None  # chr22 becomes the held-out contig
            t0 = time.perf_counter()
            afs, chunks = ingest(paths, args.window, args.overlap, args.chunk_size, WORKERS)
            out["ingest_s"] = time.perf_counter() - t0
        out["peak_rss_gb"], out["rss_gb_after_ingest"] = peak[0], rss_gb()
        train_bp = sum(L for _, _, L in paths)
        out.update(chromosomes=len(paths), chunks=int(chunks.shape[0]),
                   columns=int(chunks.shape[1]), chunk_mb=chunks.nbytes / 1e6,
                   mbp_per_s=train_bp / out["ingest_s"] / 1e6,
                   chromosome_windows=[L // args.window for _, _, L in paths])
        print(f"ingestion: {out['chunks']} chunks x {out['columns']} columns "
              f"({out['chunk_mb']:.1f} MB int8) from {len(paths)} chromosomes in "
              f"{out['ingest_s']:.2f} s ({out['mbp_per_s']:.1f} Mbp/s); host RSS through "
              f"synthesis and ingestion, read right after ingestion, before torch is imported "
              f"and before any CUDA context: peak {out['peak_rss_gb']:.3f} GB (sampled every "
              f"5 ms), {out['rss_gb_after_ingest']:.3f} GB at the end", flush=True)

        # torch only now, so that the RSS above is ingestion's: its import
        # alone (with CUDA's libraries) is larger than the chunk tensor
        import torch

        from phlash_tpu_torch.bench import smi
        from phlash_tpu_torch.kernel import resolve_device
        from phlash_tpu_torch.ops import assembly, packed, smc, svgd

        dev = resolve_device(args.device)
        cuda = dev.type == "cuda"

        out["device"] = torch.cuda.get_device_name(dev) if cuda else "cpu"
        out["card"] = ", ".join(smi(dev, "name,power.limit")) if cuda else None
        from phlash_tpu_torch.mcmc import held_out_elpd
        from phlash_tpu_torch.training import Caller, build_training, clone_state

        def sync():
            if cuda:
                torch.cuda.synchronize(dev)

        mods = {"smc": smc, "packed": packed, "assembly": assembly, "svgd": svgd}

        def counts() -> dict:
            return {name: mod.counts() for name, mod in mods.items()}

        def reset_counts():
            for mod in mods.values():
                mod.reset_counts()

        gen = torch.Generator(device=dev).manual_seed(args.seed)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        prog = build_training(chunks, afs, window_size=args.window, overlap=args.overlap,
                              device=dev, generator=gen,
                              options=dict(num_particles=args.particles, minibatch_size=5,
                                           niter=args.niter))
        spc = prog.steps_per_call

        def draw(k: int) -> torch.Tensor:
            "A call's (k, S) minibatch rows, drawn as fit draws them."
            return torch.randint(prog.N, (k, prog.S), generator=gen, device=dev)

        state, _ = prog.step(prog.state, draw(spc))  # on CUDA: warm-up, capture, replay
        sync()
        out["setup_s"] = time.perf_counter() - t0
        t0, done, calls = time.perf_counter(), spc, 1
        while done < args.niter:
            k = min(spc, args.niter - done)
            state, _ = prog.step(state, draw(k))
            done, calls = done + k, calls + 1
        sync()
        out.update(steps_per_call=spc, fit_calls=calls, iterations=done,
                   fit_s_after_first_call=time.perf_counter() - t0,
                   max_memory_allocated_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                                            if cuda else None),
                   launches_fit=counts())

        particles = state.particles
        c0 = prog.init.unflatten(particles).to_dm().eta.c[..., 0]
        out["finite"] = bool(torch.isfinite(particles).all())
        out["median_c0"] = float(c0.median())
        # on CUDA `state` is the graph's static state, which every replay
        # updates in place: each timed run starts from a copy of the fit's
        fitted = clone_state(state)

        def best_of(call, elpd_inds=None) -> float:
            "Seconds a call of spc iterations from the fitted state: best of REPS runs of INNER."
            best = float("inf")
            for _ in range(REPS):
                sync()
                t0 = time.perf_counter()
                s = fitted
                for _ in range(INNER):
                    s, _ = call(s, draw(spc), elpd_inds)
                sync()
                best = min(best, (time.perf_counter() - t0) / INNER)
            return best

        reset_counts()
        t_plain = best_of(prog.step)
        out.update(ms_per_iter=t_plain / spc * 1e3, timed_calls=REPS * INNER,
                   launches_timing=counts())
        mode = "graph replays" if cuda else "eager calls"
        print(f"fit: upload + build + first call ({spc} iterations"
              f"{', graph capture included' if cuda else ''}) {out['setup_s']:.2f} s; "
              f"the other {done - spc} iterations {out['fit_s_after_first_call']:.3f} s; "
              f"{args.particles} particles, by {mode} of {spc}: {out['ms_per_iter']:.4f} ms an "
              f"iteration (best of {REPS} runs of {INNER} calls after the fit); "
              f"on {out['device']}", flush=True)
        print("device memory: " + (f"max_memory_allocated {out['max_memory_allocated_gb']:.3f} GB"
                                   if cuda else "not measured (CPU)"), flush=True)
        print(f"posterior median c[0] after {done} iterations: {out['median_c0']:.4f}; "
              f"cloud finite: {out['finite']}", flush=True)

        if holdout is not None:
            from phlash_tpu_torch.data import contig

            p_h, c_h, L_h = holdout
            test = contig(p_h, samples=[SAMPLE], region=f"{c_h}:1-{L_h}")
            elpd = held_out_elpd(prog, test, span=int(chunks.shape[-1]), overlap=args.overlap,
                                 elpd_samples=None, device=dev, kernel_backend="smc")
            fused = Caller(prog.base_step, elpd)
            # one subset for every evaluation, as fit draws it
            elpd_inds = elpd.draw(torch.Generator(device=dev).manual_seed(args.seed + 1))
            reset_counts()
            fused(fitted, draw(spc), elpd_inds)  # on CUDA: warm-up and capture
            t_fused = best_of(fused, elpd_inds)
            calls_per_eval = max(1, -(-10 // spc))  # one ELPD every 10 iterations
            out["elpd"] = dict(test_chunks=elpd.N, samples=elpd.S, plain_call_ms=t_plain * 1e3,
                               elpd_call_ms=t_fused * 1e3,
                               overhead=(t_fused - t_plain) / (calls_per_eval * t_plain),
                               elpd_calls=REPS * INNER + 1)
            out["launches_holdout"] = counts()
            e = out["elpd"]
            print(f"held-out ELPD ({c_h}, {e['test_chunks']} chunks, {e['samples']} an "
                  f"evaluation): plain call {e['plain_call_ms']:.3f} ms, ELPD-bearing call "
                  f"{e['elpd_call_ms']:.3f} ms ({spc} iterations a call, by {mode}) -> fit "
                  f"overhead {100 * e['overhead']:.2f}% at the 10-iteration ELPD cadence",
                  flush=True)

    print(f"card: {out['card']}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
