#!/usr/bin/env python3
"""Ablation profile of the SVGD step on one card: the counterpart of tools/step_profile.py.

    python tools/torch_step_profile.py [--particles 500] [--chunk 2000] [--overlap 500] \\
        [--nchunks 2000] [--device cuda]

Where do the milliseconds of a step go?  Times the port's own program for
the production step, then for the step with one component ablated at a
time, and two parts alone (the rows of tools/step_profile.py, names letter
for letter):

  full                     the step (B particles, S = 5 chunks, AFS, warm-up)
  -afs                     afs=None (no AFS term in A1 / A2)
  -warmup                  overlap 0 (pi passes through: no filter B2 + B3)
  -sites (64-site chunks)  64 sites of each chunk after the overlap
  svgd-only (stub grad)    svgd.SVGD with a constant gradient: the RBF
                           direction and amsgrad alone
  kernel fwd+grad only     ops/kernel_smc.SMCOp forward and backward (B2 +
                           B3) at the step's (B, S, L)
  assembly fwd+grad only   ops/assembly.AssemblyOp forward and backward (A1
                           + A2) over the cloud

on 2000 random Bernoulli(0.05) chunks of overlap + chunk windows and an
AFS of 9 from numpy's default_rng(0), the cloud from a generator seeded 0.
Each row runs as the fit runs: training.Caller, a call of 10 iterations
(on CUDA a CUDA graph replay; the two parts alone are Caller steps too),
"graphed" ms = the best of 3 calls over 10; then "eager" ms, 10 eager
iterations, best of 3 runs over 10.  Each row prints both, the iterations
it ran and the hand-kernel launches they made (ops/smc, ops/packed and
ops/assembly's counts); a JSON line per row, and as its last line one JSON
object {row: graphed ms}.  Differences between rows are estimates: each
variant is a program of its own.  Runs on the card unless --device cpu is
given (then "graphed" is the Caller's eager call).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

REPS, INNER = 3, 10  # best of REPS calls (runs) of INNER iterations
SITES = 64  # the -sites row's sites of each chunk after the overlap


def build(chunks: np.ndarray, afs, overlap: int, opts: dict, dev: torch.device):
    from phlash_tpu_torch.training import build_training

    return build_training(chunks, afs, window_size=100, overlap=overlap, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0), options=opts)


def main(argv=None) -> dict:
    from phlash_tpu_torch.kernel import resolve_device
    from phlash_tpu_torch.ops import assembly, packed, smc
    from phlash_tpu_torch.params import PSMC_FIELDS, PSMCParams
    from phlash_tpu_torch.svgd import SVGD, AMSGrad
    from phlash_tpu_torch.training import Caller

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=2000)
    ap.add_argument("--overlap", type=int, default=500)
    ap.add_argument("--nchunks", type=int, default=2000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        from phlash_tpu_torch.bench import smi

        card = ", ".join(smi(dev, "name,power.limit"))
    else:
        card = "cpu"
    B, L, O, N = args.particles, args.chunk, args.overlap, args.nchunks
    rng = np.random.default_rng(0)
    chunks = rng.binomial(1, 0.05, size=(N, O + L)).astype(np.int8)
    afs = rng.integers(100, 1000, size=9).astype(np.int64)
    opts = dict(num_particles=B, minibatch_size=5, niter=100)
    gen = torch.Generator(device=dev).manual_seed(1)
    mods = {"smc": smc, "packed": packed, "assembly": assembly}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    rows, detail = {}, []

    def record(name: str, state, base_step, n_chunks: int, S: int) -> None:
        """Time `base_step` ((state, inds (S,)) -> state) graphed by a
        Caller and eagerly; print and keep the row."""
        for mod in mods.values():
            mod.reset_counts()
        call = Caller(base_step)
        inds = torch.randint(n_chunks, (REPS + 1, INNER, S), generator=gen, device=dev)
        s, _ = call(state, inds[0])  # on CUDA: an eager warm-up iteration, the capture, a replay
        sync()
        best = float("inf")
        for rows_ in inds[1:]:
            t0 = time.perf_counter()
            s, _ = call(s, rows_)
            sync()
            best = min(best, time.perf_counter() - t0)
        graphed = best / INNER * 1e3
        iters = (1 if cuda else 0) + (REPS + 1) * INNER
        s = base_step(state, inds[0, 0])  # eager warm-up
        sync()
        best = float("inf")
        for rows_ in inds[1:]:
            t0 = time.perf_counter()
            for row in rows_:
                s = base_step(s, row)
            sync()
            best = min(best, time.perf_counter() - t0)
        eager = best / INNER * 1e3
        iters += 1 + REPS * INNER
        launches = {k: mod.counts() for k, mod in mods.items()}
        rows[name] = graphed
        detail.append(dict(row=name, graphed_ms=graphed, eager_ms=eager, iterations=iters,
                           launches=launches))
        hand = {f"{k}.{c}": v for k, m in launches.items() for c, v in m.items() if v}
        print(f"{name:28s} {graphed:8.4f} ms graphed {eager:8.4f} ms eager; {iters} iterations, "
              f"launches {hand or 'none'}", flush=True)
        print(json.dumps(detail[-1]), flush=True)

    prog = build(chunks, afs, O, opts, dev)
    record("full", prog.state, prog.base_step, prog.N, prog.S)

    prog2 = build(chunks, None, O, opts, dev)
    record("-afs", prog2.state, prog2.base_step, prog2.N, prog2.S)

    prog3 = build(np.ascontiguousarray(chunks[:, O:]), afs, 0, opts, dev)
    record("-warmup", prog3.state, prog3.base_step, prog3.N, prog3.S)

    prog4 = build(np.ascontiguousarray(chunks[:, : O + SITES]), afs, O, opts, dev)
    record("-sites (64-site chunks)", prog4.state, prog4.base_step, prog4.N, prog4.S)

    # SVGD machinery alone: the same cloud, a constant gradient
    stub = SVGD(lambda flat, **kw: torch.ones_like(flat), AMSGrad(learning_rate=0.1))
    record("svgd-only (stub grad)", stub.init(prog.state.particles.clone()),
           lambda state, inds: stub.step(state), prog.N, prog.S)

    # the likelihood kernels alone, forward and backward at the step's (B, S, L)
    S = prog.S
    with torch.no_grad():
        pp = PSMCParams.from_dm(prog.init.unflatten(prog.state.particles).to_dm())
    pp = pp.replace(pi=pp.pi[:, None, :].expand(-1, S, -1))
    leaves = [getattr(pp, k).float().contiguous().requires_grad_(True) for k in PSMC_FIELDS]
    chunk_inds = torch.arange(S, device=dev)

    def kernel_step(state, inds):
        ll = prog.kern.loglik_batched(PSMCParams(*leaves), chunk_inds)
        torch.autograd.grad(ll.sum(), leaves)
        return state

    record("kernel fwd+grad only", prog.state, kernel_step, prog.N, S)

    # the assembly alone: A1 and A2 over the cloud (to_dm + from_dm, the leaves summed)
    def assembly_step(state, inds):
        x = state.particles.detach().requires_grad_(True)
        out, _, _ = assembly.assemble(prog.init.unflatten(x))
        torch.autograd.grad(sum(getattr(out, k).sum() for k in PSMC_FIELDS), x)
        return state

    record("assembly fwd+grad only", prog.state, assembly_step, prog.N, S)

    print(f"card: {card}; B={B}, S={S}, chunks of {O} + {L} windows, {N} chunks", flush=True)
    print(json.dumps(rows), flush=True)
    return dict(rows=rows, detail=detail, card=card)


if __name__ == "__main__":
    main()
