"""B6, the issue-rate micro-kernels (ops/peak.py, csrc/peak.cu), on the CPU.

- The plain version against tools/vpu_peak.py's Pallas bodies, run through
  pl.pallas_call in interpret mode with the tool's own BlockSpec, for every
  (kernel, streams, unroll) the CUDA source builds, on the same numpy-seeded
  inputs: non-finite entries equal in position and sign, finite ones
  within rtol 1e-4 (mix) or 1e-5 (the rest), chip_smoke.py phase 10's gate.
  XLA on the CPU rounds each multiply-add once, as the card's FFMA does and
  as the plain version does (ops/peak._fma).
- The same at ops/peak.SHORT steps, where every chain is finite, and
  that the check at SHORT fails a roll the wrong way, without its shuffle
  or shuffled from the wrong lane (at INNER such faults do not show).
- The built instances are the tool's sweep and mix's two plateau
  configurations, as csrc/peak.cu lists them.
- The counts of a launch, its bound and its rates; the issue count of the
  SMC' kernels (roofline.issue_per_site / issue_share) as PERF.md's
  kernel table states it, and refused outside (0, 1].
- run_cuda refuses CPU tensors; the kernel-versus-plain case needs a card.
"""

import ast
import inspect
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from phlash_tpu_torch import roofline  # noqa: E402
from phlash_tpu_torch.ops import peak  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SEED = 20240601  # chip_smoke.SEED
sys.path.insert(0, str(ROOT / "tools"))
import vpu_peak  # noqa: E402

CASES = [(w, s, u) for w, su in peak.CONFIGS.items() for s, u in su]


@pytest.fixture(scope="module")
def abc():
    return peak.inputs(SEED)


def _pallas(which, streams, unroll, a, b, c):
    "tools/vpu_peak.py run's pallas_call (one grid step), in interpret mode."
    kern, _ = vpu_peak._KERNELS[which](streams, unroll)
    spec = pl.BlockSpec((vpu_peak.TB, vpu_peak.M, vpu_peak.LANES), lambda g: (0, 0, 0),
                        memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            kern, grid=(1,), in_specs=[spec] * 3, out_specs=spec,
            out_shape=jax.ShapeDtypeStruct((vpu_peak.TB, vpu_peak.M, vpu_peak.LANES),
                                           jnp.float32),
        )(*(jnp.asarray(x.numpy()) for x in (a, b, c)))
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("which, streams, unroll", CASES,
                         ids=[f"{w}-s{s}-u{u}" for w, s, u in CASES])
def test_reference_matches_the_pallas_kernel(abc, which, streams, unroll):
    a, b, c = abc
    want = _pallas(which, streams, unroll, a, b, c)
    got = peak.reference(which, streams, unroll, a, b, c)
    gate = peak.compare(which, got, want)
    assert gate["ok"], gate
    if which == "roll":  # every chain overflows, on the TPU too
        assert gate["n_nonfinite"] == got.numel() and bool((got == np.inf).all())
    if which == "multiport":
        assert not bool(got[1:].any())


@pytest.mark.parametrize("which, streams, unroll", CASES,
                         ids=[f"{w}-s{s}-u{u}" for w, s, u in CASES])
def test_reference_matches_the_pallas_kernel_while_finite(abc, monkeypatch, which, streams,
                                                          unroll):
    """The same at the check's SHORT step count, where every chain is
    finite: the TPU tool runs SHORT // unroll * unroll steps (SHORT = 103
    itself at unroll 1, which reaches roll's wrap and direction)."""
    a, b, c = abc
    monkeypatch.setattr(vpu_peak, "INNER", peak.SHORT)
    want = _pallas(which, streams, unroll, a, b, c)
    got = peak.reference(which, streams, unroll, a, b, c, peak.SHORT // unroll * unroll)
    gate = peak.compare(which, got, want)
    assert gate["ok"] and gate["n_nonfinite"] == 0, gate


def _rolls():
    """Wrong versions of the kernel's roll along M, as csrc/peak.cu could get
    it wrong: the other way, no shuffle (each lane's SPL states turn in its
    registers), and a shuffle from lane l + 1 instead of l - 1."""
    state = torch.arange(peak.M)
    lane, r = state // peak.SPL, state % peak.SPL
    own = lane * peak.SPL + (r - 1) % peak.SPL
    wrong_lane = ((lane + 1) % peak.G) * peak.SPL + peak.SPL - 1
    return {"other way": lambda x: torch.roll(x, -1, -2),
            "no shuffle": lambda x: x[..., own, :],
            "wrong lane": lambda x: x[..., torch.where(r == 0, wrong_lane, own), :]}


@pytest.mark.parametrize("which", ["roll", "multiport"])
@pytest.mark.parametrize("fault", list(_rolls()))
def test_short_check_fails_a_wrong_roll(abc, monkeypatch, which, fault):
    """chip_smoke.py phase 10's check at SHORT steps fails each wrong roll in
    the one kernel that is a roll plus a multiply-add and in the one whose
    odd streams only roll; at INNER both kernels' outputs hide it."""
    a, b, c = abc
    streams, unroll = peak.CONFIGS[which][0]
    want = peak.reference(which, streams, unroll, a, b, c, peak.SHORT)
    real = torch.roll
    monkeypatch.setattr(torch, "roll", lambda x, s, dims: _rolls()[fault](x)
                        if (s, dims) == (1, -2) else real(x, s, dims))
    got = peak.reference(which, streams, unroll, a, b, c, peak.SHORT)
    assert not peak.compare(which, got, want)["ok"]


def test_instances_are_the_tools_sweep():
    """csrc/peak.cu builds exactly CONFIGS, which is tools/vpu_peak.py main's
    sweep plus mix at (16, 16) and (24, 16); the tool's block and step count."""
    src = (ROOT / "phlash_tpu_torch" / "csrc" / "peak.cu").read_text()
    body = re.search(r"#define PHLASH_PEAK_INSTANCES\(X\)(.*?)\n\n", src, re.S).group(1)
    built = re.findall(r"X\((\w+), (\d+), (\d+)\)", body)
    assert [(w.lower(), int(s), int(u)) for w, s, u in built] == CASES
    tree = ast.parse(inspect.getsource(vpu_peak.main))
    sweeps = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                  if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "sweeps")
    for which, su in sweeps.items():
        assert set(su) <= set(peak.CONFIGS[which])
    assert set(peak.CONFIGS["mix"]) - set(sweeps["mix"]) == {(16, 16), (24, 16)}
    assert (peak.TB, peak.M, peak.LANES, peak.INNER) == (vpu_peak.TB, vpu_peak.M,
                                                        vpu_peak.LANES, vpu_peak.INNER)
    assert peak.KINDS == tuple(w.lower() for w in
                               re.findall(r"(\w+) = \d", src.split("enum : int {")[1]
                                          .split("}")[0]))


def test_copies_and_leading_axes(abc):
    "The plain version takes copies on a leading axis: each equals the one block."
    a, b, c = abc
    one = peak.reference("mix", 4, 8, a, b, c, inner=64)
    many = peak.reference("mix", 4, 8, *(x.expand(3, *x.shape) for x in (a, b, c)), inner=64)
    assert all(torch.equal(m, one) for m in many)
    assert peak.compare("mix", many, one)["ok"]
    bad = one.clone()
    bad[0, 0, 0] = -np.inf
    assert not peak.compare("mix", bad, one)["nonfinite_match"]
    bad = one * (1 + 2e-4)
    assert not peak.compare("mix", bad, one)["ok"] and peak.compare("fma", one, one)["ok"]


def test_counts_bound_and_rates():
    """A launch's warp-instructions from the source's per-step counts, its
    bound over the data-sheet pipe rates, and shares above 1 refused."""
    n = peak.launch_counts("mix", 24, 16, copies=1)
    warps = peak.TB * peak.LANES * peak.G // 32
    assert n == {"ffma": warps * 2048 * 24 * 8, "shfl": warps * 2048 * 24,
                 "fsel": warps * 2048 * 24, "all": warps * 2048 * 24 * 10}
    mp = peak.launch_counts("multiport", 8, 8, copies=2)
    assert mp["ffma"] == 2 * 16 * 2048 * 4 * 4 and mp["shfl"] == 2 * 16 * 2048 * 4
    assert peak.warps_per_copy("multiport") * 4 == peak.warps_per_copy("fma") == 64
    copies, threads = peak.regimes("fma")["smc"]
    assert copies * peak.warps_per_copy("fma") == peak.SMC_WARPS == 320 and threads == 32
    assert peak.regimes("multiport")["filled"] == (4 * 132 * 64 // 16, 128)
    ms, by = peak.bound_ms("roll", 16, 8, copies=528)
    want = 528 * 64 * 2048 * 16 / roofline.SHFL_PEAK * 1e3
    assert ms == pytest.approx(want) and by == "operations"
    r = peak.rates("roll", 16, 8, 528, 2 * ms)
    assert r["shares"]["shfl"] == pytest.approx(0.5)
    assert r["thread_ops_per_s"] == 32 * r["warp_instr_per_s"]
    with pytest.raises(RuntimeError, match="count is wrong"):
        peak.rates("roll", 16, 8, 528, 0.5 * ms)
    results = [dict(which="mix", regime="smc", streams=s, unroll=8, warp_instr_per_s=r)
               for s, r in ((8, 3e11), (16, 4e11))]
    mix, ms = peak.smc_at_plateau(results, "smc", 500, 5, 2000)
    assert mix["streams"] == 16
    assert ms["smc_backward"] == pytest.approx(
        roofline.issue_per_site("smc_backward", 16) * 500 * 5 * 2000 / 4e11 * 1e3)


def test_ptxas_report():
    "Registers and spills of each micro-kernel instance, from a ptxas log."
    log = ("ptxas info    : Compiling entry function '_Z11peak_kernelILi2ELi24ELi16EEvPKfS1_S1_Pf'"
           " for 'sm_90a'\nptxas info    : Function properties for _Z11peak_kernel\n"
           "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 0 barriers, 380 bytes cmem[0]\n")
    assert peak.ptxas_report(log) == {("mix", 24, 16): (168, 8)}


def test_run_cuda_refuses_cpu_tensors(abc):
    "No fallback: a CPU tensor is refused before anything builds, and nothing counts."
    peak.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        peak.run_cuda("fma", 4, 1, *abc, 1, 128)
    with pytest.raises(ValueError, match="no micro-kernel"):
        peak.run_cuda("fma", 5, 1, *abc, 1, 128)
    assert peak.counts() == {"run_cuda": 0}


def test_smc_states_per_lane_is_the_headers():
    "roofline.SMC_SPL is csrc/smc_common.cuh's mapping."
    header = (ROOT / "phlash_tpu_torch" / "csrc" / "smc_common.cuh").read_text()
    mapping = re.search(r"#define PHLASH_SMC_INSTANCES\(X\) (.*)", header).group(1)
    assert roofline.SMC_SPL == {int(m): int(s) for m, s in re.findall(r"X\((\d+), (\d+)\)",
                                                                      mapping)}


# PERF.md's kernel table: warp-instructions and shuffles an instance-site at M = 16
@pytest.mark.parametrize("name, issue, shfl", [
    ("smc_forward", "9.61", "0.781"),
    ("smc_forward_residuals", "9.69", "0.781"),
    ("smc_backward", "24.9", "1.56"),
])
def test_issue_count_reproduces_the_kernel_table(name, issue, shfl):
    assert f"{roofline.issue_per_site(name, 16):.3g}" == issue
    assert f"{roofline.shuffles_per_site(name, 16):.3g}" == shfl


def test_issue_share():
    """The share of B2 + B3's issue count over a measured time, and a time
    under the count's bound refused; unknown kernels refused."""
    B, S, L = 500, 5, 20_000
    k = ("smc_forward_residuals", "smc_backward")
    per = sum(roofline.issue_per_site(n, 16) for n in k)
    bound_ms = per * B * S * L / roofline.ISSUE_PEAK * 1e3
    assert roofline.issue_share(4 * bound_ms, k, 16, B, S, L) == pytest.approx(0.25)
    with pytest.raises(RuntimeError, match="count is wrong"):
        roofline.issue_share(0.9 * bound_ms, k, 16, B, S, L)
    sh = sum(roofline.shuffles_per_site(n, 16) for n in k) * B * S * L / roofline.SHFL_PEAK
    assert roofline.issue_share(sh * 1e3 * 2, k, 16, B, S, L, "shuffle") == pytest.approx(0.5)
    with pytest.raises(ValueError, match="unknown SMC' kernel"):
        roofline.issue_per_site("packed_forward", 16)
    assert roofline.CLOCK == pytest.approx(1.9827e9, rel=1e-4)


SASS = """
\t\tFunction : _Z11peak_kernelILi1ELi4ELi1EEvPKfS1_S1_Pf
        /*0000*/                   LDC R1, c[0x0][0x28] ;                    /* 0x00000a00ff017b82 */
        /*0010*/                   SHFL.IDX PT, R3, R2, R5, 0x1c1f ;
        /*0020*/                   FFMA R4, R2, R3, R4 ;
        /*0030*/              @!P0 FFMA R6, R2.reuse, R3, R6 ;
        /*0040*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0050*/               @P0 BRA 0x10 ;                                  /* 0x000000000030 */
        /*0060*/                   EXIT ;
        /*0070*/                   BRA 0x70;
\t\tFunction : _Z18smc_forward_kernelILi16ELi4EEvPKfS1_
        /*0000*/                   FADD R1, R2, R3 ;
        /*0010*/                   SHFL.DOWN PT, R3, R2, R5, 0x1c1f ;
        /*0020*/                   FADD R1, R2, R3 ;
        /*0030*/               @P1 BRA 0x10 ;
        /*0040*/               @P0 BRA 0x0 ;
"""


def test_sass_loops():
    """tools/torch_sm_peak.py's count of a cuobjdump listing: loops by
    branch address, the innermost one, its operand-reuse flags, kernels by
    name and template arguments."""
    import torch_sm_peak

    loops = torch_sm_peak.sass_loops(SASS)
    assert set(loops) == {"peak_kernel<1, 4, 1>", "smc_forward_kernel<16, 4>"}
    inner = torch_sm_peak.innermost(loops["peak_kernel<1, 4, 1>"])
    assert {k: v for k, v in inner.items() if k != "span"} == {
        "all": 5, "reuse": 1, "SHFL": 1, "FFMA": 2, "IADD3": 1, "BRA": 1}
    assert torch_sm_peak._opcodes(inner) == "FFMA 2, SHFL 1, IADD3 1, BRA 1; operand-reuse flags 1"
    smc = torch_sm_peak.innermost(loops["smc_forward_kernel<16, 4>"])
    assert smc["all"] == 3 and smc["SHFL"] == 1 and len(loops["smc_forward_kernel<16, 4>"]) == 2


def test_sm_peak_tool_refuses_without_a_card():
    "tools/torch_sm_peak.py exits non-zero, measuring nothing, where there is no CUDA device."
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    import subprocess

    out = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_sm_peak.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "needs a CUDA device" in out.stderr
    assert "warp-instr" not in out.stdout


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    "Every micro-kernel against its plain version on a card (chip_smoke.py phase 10)."
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 10 runs this check on the card")
    import chip_smoke

    chip_smoke.check_peak(torch, torch.device("cuda", 0))
