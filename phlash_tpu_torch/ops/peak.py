"""B6: issue-rate micro-kernels, the counterpart of tools/vpu_peak.py.

phlash_tpu anchors its roofline on measured rates: tools/vpu_peak.py times
micro-kernels on the SMC' kernel's working set, because the data-sheet
ceiling is one that no roll-heavy kernel can reach.  Here the same four
micro-kernels run on the card (csrc/peak.cu), in the SMC' kernels' own
layout, and give what an H100 sustains for independent FFMA chains,
shuffle chains (the counterpart of the TPU's sublane roll), the SMC' mix of
both, and FFMA and shuffle chains side by side:

    reference(which, streams, unroll, a, b, c)   the plain version, step by
                                                 step, any device
    run_cuda(which, streams, unroll, a, b, c,    one launch of `copies`
             copies, threads)                    copies, `threads` a block
    measure(...) / sweep(a, b, c)                sustained rates on the card

Inputs are the TPU tool's: a, b, c float32 (TB, M, LANES) = (4, 16, 128),
a ~ U[0.5, 1) (here from numpy, `inputs`), b = 0.999, c = 0.001 a.  Each
of `streams` chains starts at a (1 + 0.01 k) and runs INNER steps; the
output is the chains' sum in stream order (csrc/peak.cu lists the steps).
`roll` overflows to +inf everywhere, on the TPU too; `mix` reaches ~1e38.
So the check also runs SHORT steps, where every chain is finite.

`run_cuda` counts its launches (`.launches`; `reset_counts`, `counts`).
There is no dispatch by device: the micro-kernels measure the card, so a
CPU tensor is refused, as is a failed build or launch.

Kernel design note (csrc/peak.cu).
* Replaces: B6 = tools/vpu_peak.py run (its pallas_call), bodies
  _make_fma, _make_roll, _make_mix, _make_multiport.
* What bounds it on the H100: the pipe its step issues on (FFMA: the FP32
  pipe, 4 warp-instructions a clock an SM; SHFL: the shuffle path, 1;
  every instruction: 4 dispatches a clock an SM), or with few warps an SM
  the latency of each chain; no memory inside the loop.
* What the design does about it: nothing to hide; it measures.  The layout
  is the SMC' kernels' (a column of 16 states on 4 lanes, 4 registers a
  lane), `streams` and `unroll` are template parameters (the TPU tool's
  sweep), and `copies` and `threads` a block are arguments, so one sweep
  runs the card filled and the SMC' kernels' one-warp-block geometry.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from phlash_tpu_torch import roofline
from phlash_tpu_torch.ops.build import check, load_library, ptr, require_cuda, stream

TB, M, LANES = 4, 16, 128  # tools/vpu_peak.py's block
INNER = 2048  # steps a chain (tools/vpu_peak.py INNER)
# The check's second step count: roll's chains stay finite (1.999^103 ~ 1e31,
# against +inf everywhere after INNER), and 103 = 7 mod M, so a shuffle from
# the wrong lane, none (a 4-cycle in the lane's registers) or a roll the wrong
# way changes the output; after INNER = 0 mod M steps a 16-cycle of states,
# multiport's odd streams, is back where it began.  No unroll divides it, so
# the kernel's loop of leftover steps runs too.
SHORT = 103
SPL = 4  # states a lane
G = M // SPL  # lanes a column
KINDS = ("fma", "roll", "mix", "multiport")  # csrc/peak.cu's kind codes, in order
# (streams, unroll) built for each micro-kernel, as csrc/peak.cu
# PHLASH_PEAK_INSTANCES lists them: tools/vpu_peak.py main's sweep, and mix at
# the plateau configurations (16, 16) and (24, 16) that sweep leaves out
CONFIGS = {
    "fma": ((4, 1), (4, 8), (8, 8), (16, 8)),
    "roll": ((4, 1), (4, 8), (8, 8), (16, 8)),
    "mix": ((4, 1), (4, 8), (8, 8), (16, 8), (16, 16), (24, 16)),
    "multiport": ((8, 8), (16, 8), (24, 8), (32, 8)),
}
# warp-instructions a lane issues a step for one stream, counted from the
# source (csrc/peak.cu); multiport: (even stream, odd stream)
STEP_COUNTS = {
    "fma": {"ffma": 4},
    "roll": {"ffma": 4, "shfl": 1},
    "mix": {"ffma": 8, "shfl": 1, "fsel": 1},
    "multiport": ({"ffma": 4}, {"shfl": 1}),
}
# launch regimes: (copies a kernel -> copies, threads a block)
SMC_WARPS = 320  # ~ the SMC' kernels' 315 one-warp blocks at B = 500, S = 5, M = 16
FILLED_WARPS = 4 * 132 * 64  # four waves of the 64 warps an SM can hold, on 132 SMs
MIX_RTOL, RTOL = 1e-4, 1e-5  # the gate: finite entries of mix, of the others
REPS, WINDOW = 3, 10  # measure: the best of REPS windows of WINDOW launches


def warps_per_copy(which: str) -> int:
    "Warps one copy of the block's work takes: a column of M states on G lanes."
    return (LANES if which == "multiport" else TB * LANES) * G // 32


def regimes(which: str) -> dict:
    """{regime: (copies, threads a block)}: "filled", four waves of full
    SMs in blocks of 128; "smc", SMC_WARPS one-warp blocks."""
    w = warps_per_copy(which)
    return {"filled": (FILLED_WARPS // w, 128), "smc": (SMC_WARPS // w, 32)}


def inputs(seed: int, device="cpu"):
    """(a, b, c) as the TPU tool makes them (tools/vpu_peak.py measure), a
    drawn with numpy from `seed`."""
    a = np.random.default_rng(seed).uniform(0.5, 1.0, (TB, M, LANES)).astype(np.float32)
    b = np.full((TB, M, LANES), 0.999, np.float32)
    c = np.float32(0.001) * a
    return tuple(torch.from_numpy(x).to(device) for x in (a, b, c))


def _check(which: str, streams: int, unroll: int) -> None:
    if (streams, unroll) not in CONFIGS.get(which, ()):
        raise ValueError(f"no micro-kernel {which!r} at streams={streams}, unroll={unroll}; "
                         f"built: {CONFIGS}")


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x y + z rounded once to float32, as the card's FFMA and XLA on the CPU
    round it: the float32 product is exact in float64, so only the sum
    rounds (twice, in float64 then float32, which differs from one rounding
    only at a float32 tie that float64 rounded onto)."""
    return (x.double() * y.double() + z.double()).float()


def reference(which: str, streams: int, unroll: int, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, inner: int = INNER) -> torch.Tensor:
    """The plain version: the TPU kernel's recurrence, `inner` steps one by
    one, on float32 a, b, c (..., TB, M, LANES), on their device; every
    multiply-add of a step is one rounding (`_fma`), as a fused operation on
    the card and in XLA's CPU code.  `unroll` does not change the result (the
    TPU tool runs inner // unroll * unroll steps: the same at INNER, which
    every unroll divides).
    The streams run side by side as one stacked tensor (they are
    independent, elementwise but for the roll along M), and are summed in
    stream order in float32."""
    _check(which, streams, unroll)
    if not all(t.dtype == torch.float32 for t in (a, b, c)):
        raise ValueError("the micro-kernels are float32")
    f = [torch.tensor(1.0 + 0.01 * k, dtype=a.dtype, device=a.device) for k in range(streams)]
    roll = lambda x: torch.roll(x, 1, dims=-2)  # noqa: E731  out[m] = x[m - 1 mod M]
    if which == "multiport":
        row = lambda k: a[..., k % TB, :, :] * f[k]  # noqa: E731
        b0, c0 = b[..., 0, :, :], c[..., 0, :, :]
        even = torch.stack([row(k) for k in range(0, streams, 2)])
        odd = torch.stack([row(k) for k in range(1, streams, 2)])
        for _ in range(inner):
            even = _fma(even, b0, c0)
            odd = roll(odd)
        chains = [(even, odd)[k % 2][k // 2] for k in range(streams)]
    else:
        x = torch.stack([a * fk for fk in f])
        if which == "mix":
            first = torch.arange(M, device=a.device).view(M, 1) >= 1
            zero = torch.zeros((), dtype=a.dtype, device=a.device)
        for _ in range(inner):
            if which == "fma":
                x = _fma(x, b, c)
            elif which == "roll":
                x = _fma(b, x, roll(x))
            else:  # b a + where(m >= 1, roll(a), 0) + c a
                x = _fma(c, x, _fma(b, x, torch.where(first, roll(x), zero)))
        chains = list(x)
    total = chains[0]
    for ch in chains[1:]:
        total = total + ch
    if which != "multiport":
        return total
    out = torch.zeros_like(a)
    out[..., 0, :, :] = total
    return out


def compare(which: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """The gate of a micro-kernel's output against its plain version: the
    non-finite entries equal in position and sign, the finite ones within
    rtol MIX_RTOL (mix) or RTOL (the rest); `got` may hold copies on a
    leading axis, each held to `want` on its own."""
    got, want = got.double(), want.double().expand_as(got)
    fg, fw = torch.isfinite(got), torch.isfinite(want)
    nonfinite = bool(torch.equal(fg, fw)) and bool(
        torch.equal(torch.sign(got[~fg]), torch.sign(want[~fw])))
    both = fg & fw
    diff = (got - want).abs()[both]
    scale = want.abs()[both]
    rel = float((diff / scale.clamp_min(1e-300)).max()) if diff.numel() else 0.0
    rtol = MIX_RTOL if which == "mix" else RTOL
    ok = nonfinite and bool((diff <= rtol * scale).all())
    return dict(ok=ok, nonfinite_match=nonfinite, n_nonfinite=int((~fw).sum()),
                max_rel_err=rel, max_abs_err=float(diff.max()) if diff.numel() else 0.0,
                rtol=rtol)


def run_cuda(which: str, streams: int, unroll: int, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, copies: int, threads: int, inner: int = INNER) -> torch.Tensor:
    """One launch of micro-kernel `which` at (streams, unroll), `inner`
    steps a chain: `copies` copies of the block's work, `threads` a block;
    (copies, TB, M, LANES)."""
    _check(which, streams, unroll)
    dev = require_cuda([a, b, c])
    for t in (a, b, c):
        if tuple(t.shape) != (TB, M, LANES):
            raise ValueError(f"a, b, c must be {(TB, M, LANES)}, got {tuple(t.shape)}")
    lib = load_library()
    out = torch.empty(copies, TB, M, LANES, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lib.phlash_peak(KINDS.index(which), streams, unroll, ptr(a), ptr(b), ptr(c),
                                  inner, copies, threads, ptr(out), stream(dev))
    check(lib, err, f"peak {which} launch (streams={streams}, unroll={unroll}, inner={inner}, "
                    f"copies={copies}, threads={threads})")
    run_cuda.launches += 1
    return out


def reset_counts() -> None:
    run_cuda.launches = 0


def counts() -> dict:
    return dict(run_cuda=run_cuda.launches)


reset_counts()


def step_counts(which: str, streams: int) -> dict:
    "Warp-instructions by kind a lane issues a step over all `streams` chains."
    per = STEP_COUNTS[which]
    out: dict = {}
    for k in range(streams):
        for op, n in (per[k % 2] if which == "multiport" else per).items():
            out[op] = out.get(op, 0) + n
    return out


def launch_counts(which: str, streams: int, unroll: int, copies: int) -> dict:
    """Warp-instructions by kind one launch issues in its steps (the loop's
    own counter and branch, the set-up and the sum are not counted), and
    "all" of them."""
    warps = copies * warps_per_copy(which)
    steps = INNER // unroll * unroll
    n = {op: warps * steps * v for op, v in step_counts(which, streams).items()}
    n["all"] = sum(n.values())
    return n


def bound_ms(which: str, streams: int, unroll: int, copies: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of one launch: its FFMAs over the FP32 pipe, its
    shuffles over the shuffle path, and its bytes (a, b, c read once, the
    output written once) over the memory rate, whichever is longest."""
    n = launch_counts(which, streams, unroll, copies)
    t_ops = max(n.get("ffma", 0) / roofline.FFMA_PEAK, n.get("shfl", 0) / roofline.SHFL_PEAK)
    t_bytes = 4 * TB * M * LANES * (3 + copies) / roofline.PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def rates(which: str, streams: int, unroll: int, copies: int, ms: float) -> dict:
    """What a launch of `ms` sustained: warp-instructions/s ("all", and by
    kind), thread-operations/s (32 lanes a warp-instruction), and the shares
    of the data-sheet ceilings (roofline.py): FFMA of the FP32 pipe, SHFL of
    the shuffle path, all of the issue ceiling.  A share above 1 means a
    wrong count, and raises."""
    n = launch_counts(which, streams, unroll, copies)
    per_s = {op: v / (ms * 1e-3) for op, v in n.items()}
    shares = {"ffma": per_s.get("ffma", 0.0) / roofline.FFMA_PEAK,
              "shfl": per_s.get("shfl", 0.0) / roofline.SHFL_PEAK,
              "issue": per_s["all"] / roofline.ISSUE_PEAK}
    if any(s > 1.0 for s in shares.values()):
        raise RuntimeError(f"{which} at streams={streams}, unroll={unroll}: shares {shares} "
                           f"above 1 in {ms} ms; the count is wrong")
    return dict(warp_instr_per_s=per_s["all"], thread_ops_per_s=32 * per_s["all"],
                by_kind_per_s=per_s, shares=shares)


def _ms_per_launch(fn, n: int) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def measure(which: str, streams: int, unroll: int, a, b, c, copies: int, threads: int) -> dict:
    """One warm launch, then the best of REPS windows of WINDOW launches
    between CUDA events (tools/vpu_peak.py measure's scheme): ms a launch
    and its `rates`."""
    fn = lambda: run_cuda(which, streams, unroll, a, b, c, copies, threads)  # noqa: E731
    fn()
    torch.cuda.synchronize(a.device)
    ms = min(_ms_per_launch(fn, WINDOW) for _ in range(REPS))
    return dict(which=which, streams=streams, unroll=unroll, copies=copies, threads=threads,
                warps=copies * warps_per_copy(which), ms=ms,
                **rates(which, streams, unroll, copies, ms))


def sweep(a, b, c) -> list[dict]:
    "measure() of every built configuration in each regime."
    out = []
    for which in KINDS:
        for regime, (copies, threads) in regimes(which).items():
            for streams, unroll in CONFIGS[which]:
                r = measure(which, streams, unroll, a, b, c, copies, threads)
                out.append(dict(r, regime=regime))
    return out


def best(results: list[dict], regime: str) -> dict:
    "{kind: the result of its highest warp-instruction rate in `regime`}."
    out = {}
    for r in results:
        if r["regime"] == regime and (r["which"] not in out or r["warp_instr_per_s"]
                                      > out[r["which"]]["warp_instr_per_s"]):
            out[r["which"]] = r
    return out


def smc_at_plateau(results: list[dict], regime: str, B: int, S: int,
                   L: int) -> tuple[dict, dict]:
    """(the best mix result of `regime`, {SMC' kernel: ms}): what B1, B2
    and B3 would take at (B, S, L) and the micro-kernels' M = 16 if they
    issued their counted instructions (roofline.issue_per_site) at that
    measured rate."""
    mix = best(results, regime)["mix"]
    return mix, {n: roofline.issue_per_site(n, M) * B * S * L / mix["warp_instr_per_s"] * 1e3
                 for n in roofline.SMC_KERNELS}


def sweep_lines(results: list[dict]) -> list[str]:
    """One line a kernel and regime, as tools/vpu_peak.py prints its sweep:
    G warp-instructions/s (ms a launch) at each (streams, unroll), and the
    best."""
    lines = []
    for which in KINDS:
        for regime in ("filled", "smc"):
            rs = [r for r in results if r["which"] == which and r["regime"] == regime]
            if not rs:
                continue
            top = max(rs, key=lambda r: r["warp_instr_per_s"])
            cells = "  ".join(f"s={r['streams']}/u={r['unroll']}: "
                              f"{r['warp_instr_per_s'] / 1e9:6.2f} ({r['ms']:.4f} ms)" for r in rs)
            lines.append(f"{which:9s} {regime:6s} ({rs[0]['warps']} warps, {rs[0]['threads']} "
                         f"threads a block) G warp-instr/s  {cells}   (best s={top['streams']}/"
                         f"u={top['unroll']}: {top['ms']:.4f} ms, {top['thread_ops_per_s'] / 1e12:.2f}"
                         f" T thread-ops/s; shares FFMA {top['shares']['ffma']:.3f}, SHFL "
                         f"{top['shares']['shfl']:.3f}, issue {top['shares']['issue']:.3f})")
    return lines


def ptxas_report(log: str) -> dict:
    """{(kind, streams, unroll): (registers, spill-store bytes)} of each
    built micro-kernel, from the library's ptxas log (build.Library)."""
    out, key, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+peak_kernelILi(\d+)ELi(\d+)ELi(\d+)EE",
                      line)
        if m:
            k, s, u = map(int, m.groups())
            key, spill = (KINDS[k], s, u), 0
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key] = (int(m.group(1)), spill)
            key = None
    return out

