"""`python -m phlash_tpu_torch bench` on the CPU: the JAX bench's workload
and loss, the shape of the bench's line, its refusals, and the roofline
count that it and chip_smoke.py's kernel table share.

The bench's inputs must be the JAX bench's (bench.py:119-126) bit for bit,
and its loss and gradient (the smc backend's plain version at float64)
those of phlash_tpu's PureXLAKernel and dense kernel at float64: values
1e-10 relative, gradients 1e-8 of max|JAX|.  The bench reads the
per-particle leaves at chunk 0, as phlash_tpu's SMCKernel does, so their
gradient is the JAX per-chunk gradient summed over the chunks; pi's is per
instance in both.  Whether there is a card is decided inside the tests.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from phlash_tpu.hmm import PureXLAKernel  # noqa: E402
from phlash_tpu.ops.kernel_dense import DenseKernel  # noqa: E402
from phlash_tpu.params import PSMCParams as JaxPSMCParams  # noqa: E402
from phlash_tpu.size_history import DemographicModel as JaxDM  # noqa: E402
from phlash_tpu_torch import bench, convert, roofline  # noqa: E402
from phlash_tpu_torch.kernel import get_kernel  # noqa: E402
from phlash_tpu_torch.params import PSMC_FIELDS  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the bench's tiny shape on the CPU (the plain versions)
TINY = dict(B=2, S=2, L=160, L_base=40, gate_shape=(4, 2, 1200), svgd_chunks=(8, 120),
            svgd_particles=4, overlap=40, inner=1, reps=1)
# extra keys the port's line adds to the JAX bench's, which drops
# vpu_issue_peak_fraction_fwd / _fwd_grad (a TPU VPU's issue ceiling; the
# H100's counterparts are sm_issue_peak_fraction_* and the shuffle path's)
ADDED = {"device", "kernel", "device_name", "power_limit", "torch", "cuda", "gate", "launches",
         "clocks_sm_mhz", "power_draw_w", "peak_mem_MB",
         "roofline_fraction_fwd", "roofline_fraction_fwd_grad", "roofline_bound_by_fwd",
         "roofline_bound_by_fwd_grad", "packed_roofline_fraction_fwd",
         "packed_roofline_fraction_fwd_grad", "packed_roofline_bound_by_fwd",
         "packed_roofline_bound_by_fwd_grad", "packed_fwd_grad_Msites_per_sec",
         "packed_fwd_only_Msites_per_sec", "svgd_capture_s", "packed_svgd_step_ms_per_iter",
         "packed_svgd_capture_s", "assembly_fwd_ms", "assembly_grad_ms", "assembly_particles",
         "sm_issue_peak_fraction_fwd", "sm_issue_peak_fraction_fwd_grad",
         "sm_shuffle_peak_fraction_fwd", "sm_shuffle_peak_fraction_fwd_grad"}
PLAIN = {"smc_plain_forward", "smc_plain_backward", "packed_plain_forward",
         "packed_plain_backward", "assembly_plain_forward", "assembly_plain_backward"}


def jax_workload(M, B, S, L):
    "bench.py:119-126, at (M, B, S, L)."
    rng = np.random.default_rng(0)
    data = rng.binomial(1, 0.05, size=(max(8, S), L)).astype(np.int8)
    data[:, 1000:1100] = -1
    dm = JaxDM.default(pattern=f"{M}*1", theta=1e-2, rho=1e-2)
    pp = jax.tree.map(lambda a: a.astype(jnp.float32), JaxPSMCParams.from_dm(dm))
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, S) + a.shape), pp)
    return data, pps, jnp.arange(S)


@pytest.mark.parametrize("M", [16, 32, 64])
def test_workload_matches_jax_bench(M):
    "Rows bitwise, every PSMCParams leaf equal at float32 (0 difference), the indices."
    data, pps, inds = bench.workload(M=M, B=4, S=2, L=1200, device="cpu")
    jdata, jpps, jinds = jax_workload(M, 4, 2, 1200)
    np.testing.assert_array_equal(data, jdata)
    assert data.dtype == np.int8 and (data[:, 1000:1100] == -1).all()
    want = convert.from_reference_psmc(jpps, dtype=torch.float32)
    for k in PSMC_FIELDS:
        got = getattr(pps, k)
        assert got.dtype == torch.float32 and got.shape == (4, 2, M), k
        assert torch.equal(got, getattr(want, k)), k
    np.testing.assert_array_equal(inds.numpy(), np.asarray(jinds))


@pytest.mark.parametrize("M", [16, 32])
@pytest.mark.parametrize("jax_kernel", [PureXLAKernel, DenseKernel], ids=["scan", "dense"])
def test_loss_and_grad_match_jax_bench(M, jax_kernel):
    """The bench's loss and gradient (smc, plain version, float64) against the
    JAX bench's `loss` / `jax.grad(loss)` on the same float64 inputs."""
    B, S, L = 3, 2, 1200
    data, pps, inds = bench.workload(M=M, B=B, S=S, L=L, device="cpu")
    pps = pps.to(dtype=torch.float64)
    kern = get_kernel(M, data, "cpu", backend="smc")
    fwd_grad, fwd = bench.passes(kern, pps, inds)
    value, grads = float(fwd()), fwd_grad()

    jkern = jax_kernel(M=M, data=data, double_precision=True)
    jpps = JaxPSMCParams(**convert.psmc_fields(pps))

    def jloss(p):
        return jkern.loglik_batched(p, jnp.arange(S)).sum()

    jvalue, jgrads = jax.value_and_grad(jloss)(jpps)
    np.testing.assert_allclose(value, float(jvalue), rtol=1e-10)
    for k, g in zip(PSMC_FIELDS, grads):
        want = np.asarray(getattr(jgrads, k))
        g = g.numpy()
        if k != "pi":  # read at chunk 0: the per-chunk gradients' sum lands there
            assert not g[:, 1:].any(), k
            g, want = g[:, 0], want.sum(1)
        assert np.abs(g - want).max() <= 1e-8 * np.abs(want).max(), k


def test_line_on_the_cpu(capsys):
    """main("cpu") at a tiny shape prints one JSON line whose keys are the
    JAX bench's (BENCH_r05.json) with the documented changes; every window
    ran the plain versions, and no device number is written."""
    assert bench.main("cpu", **TINY) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    ref = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]
    assert set(line) == set(ref)
    want = set(ref["extra"]) - {"vpu_issue_peak_fraction_fwd",
                                "vpu_issue_peak_fraction_fwd_grad"} | ADDED
    extra = line["extra"]
    assert set(extra) == want
    assert line["metric"] == ref["metric"] and line["unit"] == "Msites/sec"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert extra["device"] == "cpu" and extra["kernel"] == "plain"
    assert extra["gate"]["ok"] and extra["gate"]["shape"] == [4, 2, 1200]
    assert extra["ours_L"] == 160 and extra["baseline_L"] == 40
    assert extra["m32_backend"] == extra["m64_backend"] == "SMCKernel"
    assert extra["svgd_steps_per_call"] == 1  # the CPU steps eagerly, one iteration a call
    for k in ADDED - {"device", "kernel", "torch", "gate", "launches", "svgd_capture_s",
                      "packed_fwd_grad_Msites_per_sec", "packed_fwd_only_Msites_per_sec",
                      "packed_svgd_step_ms_per_iter", "packed_svgd_capture_s",
                      "assembly_fwd_ms", "assembly_grad_ms", "assembly_particles"}:
        assert extra[k] is None, k
    windows = extra["launches"]
    assert set(windows) == {"fwd_only", "fwd_grad", "baseline", "m32_fwd_grad", "m32_fwd_only",
                            "m64_fwd_grad", "m64_fwd_only", "packed_fwd_grad", "packed_fwd_only",
                            "smc_svgd_first_call", "smc_svgd", "packed_svgd_first_call",
                            "packed_svgd", "assembly_fwd", "assembly_grad"}
    assert windows["baseline"] == {}
    assert windows["fwd_grad"] == {"smc_plain_forward": 2, "smc_plain_backward": 2}
    assert windows["packed_svgd"] == {"packed_plain_forward": 9, "packed_plain_backward": 9,
                                      "assembly_plain_forward": 9, "assembly_plain_backward": 9}
    assert windows["assembly_fwd"] == {"assembly_plain_forward": 31}
    assert windows["assembly_grad"] == {"assembly_plain_backward": 31}
    assert extra["assembly_particles"] == 4 and extra["assembly_fwd_ms"] > 0
    assert all(set(w) <= PLAIN for w in windows.values())


def test_failed_gate_prints_null_and_exits_1(capsys, monkeypatch):
    "A gate over its limit: the line carries value null and the gate's errors; main returns 1."
    monkeypatch.setattr(bench, "GATE_LL_RTOL", 0.0)
    assert bench.main("cpu", **TINY) == 1
    line = json.loads(capsys.readouterr().out)
    assert line["value"] is None and line["vs_baseline"] is None
    assert not line["extra"]["gate"]["ok"] and line["extra"]["gate"]["max_rel_err_ll"] > 0
    assert "launches" not in line["extra"]


def test_window_without_its_kernels_fails():
    "A window that launched other kernels than it is named for fails the run."
    counted = bench.Launches()
    data, pps, inds = bench.workload(B=2, S=2, L=64, device="cpu")
    fwd = bench.passes(get_kernel(16, data, "cpu", backend="smc"), pps, inds)[1]
    counted.count("fwd_only", fwd)
    counted.check("fwd_only", ("smc_plain_forward",), 1)
    with pytest.raises(RuntimeError, match="expected"):
        counted.check("fwd_only", ("B1",), 1)


def test_roofline_share_over_one_fails():
    "A measured time under the bound means a wrong count: it fails, and is not reported."
    share, by = bench.roofline_share(1.0, ("smc_forward",), 16, 500, 5, 20_000)
    assert 0 < share <= 1 and by == {"smc_forward": "operations"}
    with pytest.raises(RuntimeError, match="count is wrong"):
        bench.roofline_share(0.01, ("smc_forward",), 16, 500, 5, 20_000)


def test_refused_without_a_card():
    "The default device is the card: without one, run() raises (no CPU fallback)."
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()


def test_imports_leave_jax_out():
    "Importing the bench and the roofline count imports neither JAX nor phlash_tpu."
    code = ("import sys, phlash_tpu_torch.bench, phlash_tpu_torch.roofline; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'phlash_tpu.'))"
            " or m == 'phlash_tpu']; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                       os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# PERF.md's kernel table at the fit shape (B = 500, S = 5, L = 2000, M = 16)
@pytest.mark.parametrize("name, bound_ms, by", [
    ("smc_forward", "0.0111", "operations"),
    ("smc_forward_residuals", "0.0121", "bytes"),
    ("smc_backward", "0.0444", "operations"),
    ("packed_forward", "0.0419", "operations"),
    ("packed_backward", "0.133", "operations"),
])
def test_roofline_reproduces_the_kernel_table(name, bound_ms, by):
    "Each kernel's bound, to 3 significant figures, and what bounds it."
    ms, got_by = roofline.kernel_bound(name, 16, 500, 5, 2000)
    assert f"{ms:.3g}" == bound_ms and got_by == by


def test_roofline_counts():
    """B4's checkpoints (one (B * S, M) state a period) add their bytes,
    padding lowers the operations, and an unknown kernel is refused."""
    ckpt = roofline.kernel_bytes("packed_forward_ckpt", 16, 500, 5, 2000)
    assert ckpt - roofline.kernel_bytes("packed_forward", 16, 500, 5, 2000) == 4 * 250 * 2500 * 16
    full = roofline.kernel_bound("smc_backward", 16, 500, 5, 2000)[0]
    assert roofline.kernel_bound("smc_backward", 16, 500, 5, 2000, live=0.5 * 500 * 5 * 2000)[
        0] == pytest.approx(full / 2)
    with pytest.raises(ValueError, match="unknown kernel"):
        roofline.kernel_bound("smc", 16, 500, 5, 2000)
