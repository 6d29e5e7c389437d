"""The packed fit path (kernel_backend="packed", overlap 0) on the CPU against the benchmark's reference.

The benchmark's diploid.packed cell runs `phlash_tpu_torch.fit` on the
dense-transition kernels B4 / B5 with no overlap, and judges the window's
first call against the plain float64 reference under benchmark/reference/
(plain torch, nothing of the port).  Here the port's own path (build_training's
kernel and program, model.log_density_batched, mcmc.held_out_elpd) runs on
the CPU, where B4 / B5 are their plain versions in the parameters' dtype,
on seeded random particles at a small size, and is held to that reference:
the log-density and its gradient, and the held-out ELPD.  Then the fit's
work counters packed_sites and packed_ckpt_bytes (profiling.FitTrace.counts),
which the benchmark's packed_ckpt_mb_per_iter reads, against the
arithmetic of the launches' shapes; and chip_smoke.py's phase 12b
rehearsed with the plain versions in the CUDA wrappers' place.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import fit as reference  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from phlash_tpu_torch import mcmc, profiling, training  # noqa: E402
from phlash_tpu_torch.data import RawContig, chunk_het_matrix  # noqa: E402
from phlash_tpu_torch.kernel import check_backend  # noqa: E402
from phlash_tpu_torch.model import log_density_batched  # noqa: E402
from phlash_tpu_torch.ops import packed, smc  # noqa: E402

WINDOW = 100
CHUNK = 203  # windows a chunk: not a multiple of the kernels' period of 8
P, S = 6, 3
PATTERN = "14*1+1*2"


def _het(rows: int, windows: int, seed: int) -> np.ndarray:
    "int8 (rows, windows): het windows at 8%, a missing stretch, the rest hom."
    rng = np.random.default_rng(seed)
    het = (rng.random((rows, windows)) < 0.08).astype(np.int8)
    het[:, windows // 3: windows // 3 + 40] = -1
    return het


TRAIN = RawContig(het_matrix=_het(1, 5 * CHUNK + 77, 1), afs=np.array([41.0]), window_size=WINDOW)
HELD_OUT = RawContig(het_matrix=_het(1, 3 * CHUNK + 11, 2), afs=np.array([17.0]),
                     window_size=WINDOW)


def _case(dtype: str):
    """(dtype, the port's program and held-out ELPD, the reference's problem,
    particles (P, D), the minibatch rows, the held-out rows) of one
    packed program on TRAIN / HELD_OUT, the cloud in float64
    (double_precision_params) or float32 (fit's default)."""
    f64 = dtype == "float64"
    chunks = chunk_het_matrix(TRAIN.het_matrix, overlap=0, chunk_size=CHUNK)
    prog = training.build_training(
        chunks, TRAIN.afs, window_size=WINDOW, overlap=0, device=torch.device("cpu"),
        options=dict(num_particles=P, minibatch_size=S, pattern=PATTERN,
                     double_precision_params=f64),
        generator=torch.Generator().manual_seed(11), kernel_backend="packed")
    elpd = mcmc.held_out_elpd(prog, HELD_OUT, span=CHUNK, overlap=0, elpd_samples=None,
                              device=torch.device("cpu"), kernel_backend="packed")
    x = prog.state.particles
    inds = torch.tensor([4, 0, 4])  # drawn with replacement, as fit draws them
    test_inds = torch.tensor([2, 0, 3, 1])[: elpd.S]
    pb = reference.Problem(
        chunks=reference.chunk_rows(TRAIN.het_matrix, 0, CHUNK), overlap=0, afs=TRAIN.afs,
        T=ref_model.default_afs_transform(TRAIN.afs), theta=prog.init.theta, pattern=PATTERN,
        alpha=0.0, beta=0.0, lr=0.1, S=S, x0=x.double(), inds=inds[None],
        test_chunks=reference.chunk_rows(HELD_OUT.het_matrix, 0, CHUNK),
        test_afs=HELD_OUT.afs, elpd_inds=test_inds.numpy())
    return dtype, prog, elpd, pb, x, inds, test_inds


@pytest.fixture(scope="module", params=["float64", "float32"])
def case(request):
    return _case(request.param)


def _port_density(prog, x, inds):
    "(P,) log-densities of the port's packed path, and their gradient (P, D) by autograd."
    x = x.detach().requires_grad_(True)
    d = log_density_batched(prog.init.unflatten(x), c=(1.0, prog.N / prog.S, 1.0), inds=inds,
                            warmup=prog.warmup[inds], kern=prog.kern, afs=prog.afs,
                            afs_transform=prog.afs_transform)
    (g,) = torch.autograd.grad(d.sum(), x)
    return d.detach().double(), g.double()


# The port and the reference compute the same quantity by different routes:
# the port's per-site forward (B4's plain version) and its assembly
# (params / transition / ops.assembly), the reference's blocked transfer
# matrices and its own model.py.  In float64 they differ by the rounding of
# those orders alone: 4e-16 relative in the density and the ELPD, 4e-14 of
# max|grad| in the gradient at these 609 sites a minibatch, so 1e-12 / 1e-11
# leave more than two orders of magnitude of room and still fail a term
# changed in its twelfth digit.  In float32 (the fit's cloud and kernels)
# the port rounds every site's product and normalizer to 24 bits: 1.3e-6
# relative in the density, 2.1e-7 in the ELPD (whose sum over four chunks
# and the mean over particles average the rounding), 2.0e-5 of max|grad|
# (the float32 assembly's time grid amplifies the rounding: PERF.md sec. 6),
# so 2e-5 / 5e-6 / 5e-4: ~15-25x above those readings, and still under
# what the next precision down gives on the same case (the reference with
# TF32 operands: 3.6e-4 relative in the density, 7.7e-5 in the ELPD;
# bfloat16: 4.4e-3, 1.2e-3).
TOL = {"float64": dict(density=1e-12, grad=1e-11, elpd=1e-12),
       "float32": dict(density=2e-5, grad=5e-4, elpd=5e-6)}


def test_the_log_density_is_the_references(case):
    dtype, prog, _, pb, x, inds, _ = case
    got, _ = _port_density(prog, x, inds)
    want = reference.density(pb, x.double())
    assert torch.isfinite(want).all()
    err = float(((got - want).abs() / want.abs()).max())
    assert err <= TOL[dtype]["density"], err


def test_the_gradient_is_the_references(case):
    dtype, prog, _, pb, x, inds, _ = case
    _, got = _port_density(prog, x, inds)
    want = reference.density_grad(pb, x.double(), inds.numpy(), reference.Arith())
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= TOL[dtype]["grad"], err


def test_the_held_out_elpd_is_the_references(case):
    dtype, _, elpd, pb, x, _, test_inds = case
    assert elpd.S == len(test_inds) == 4  # max(S, 4) of the held-out chunks
    got = float(elpd(x, test_inds))
    want = reference.elpd(pb, x.double())
    assert abs(got - want) / abs(want) <= TOL[dtype]["elpd"], (got, want)


def test_the_reference_chunks_the_rows_as_fit_does():
    for c in (TRAIN, HELD_OUT):
        assert np.array_equal(chunk_het_matrix(c.het_matrix, 0, CHUNK),
                              reference.chunk_rows(c.het_matrix, 0, CHUNK))


FIT = dict(device="cpu", num_particles=4, chunk_size=CHUNK, minibatch_size=2, progress=False,
           seed=5, niter=6, steps_per_call=3, check_every=3)


@pytest.fixture(scope="module")
def fits():
    """{backend: (the fit's FitTrace, the packed launch counts of the fit)}:
    one tiny CPU fit on the packed kernels (overlap 0) and one on smc."""
    out = {}
    for backend, overlap in (("packed", 0), ("smc", 20)):
        packed.reset_counts()
        mcmc.fit([TRAIN], HELD_OUT, kernel_backend=backend, overlap=overlap, **FIT)
        out[backend] = profiling.last_fit(), packed.counts()
    return out


def test_packed_work_counts_are_the_launches_shapes(fits):
    """packed_sites: B * S * L of every forward and adjoint (L the kernel's
    padded rows); packed_ckpt_bytes: ceil(L / 8) x B x S x 16 float32 of
    every forward with checkpoints, i.e. of every iteration."""
    rec, n = fits["packed"]
    L = -(-CHUNK // packed.DEFAULT_SEG) * packed.DEFAULT_SEG
    iters, elpds = n["backward_plain"], n["forward_plain"] - n["backward_plain"]
    assert rec.iterations == iters == FIT["niter"] and elpds >= 1
    S_elpd = 4  # max(S, 4) held-out chunks, of the 4 there are
    B, S_fit = FIT["num_particles"], FIT["minibatch_size"]
    assert rec.counts["packed_sites"] == (2 * iters * B * S_fit + elpds * B * S_elpd) * L
    assert rec.counts["packed_ckpt_bytes"] == iters * (L // 8) * B * S_fit * 16 * 4


def test_a_packed_fit_records_the_split_kernels_device_counts(fits, monkeypatch):
    """A packed fit's record closes with the four device counts of B4 / B5's
    split launches, zeros on the CPU (the plain versions split nothing), so
    the benchmark's packed_fix_share reads 0 there."""
    import importlib.util

    rec, _ = fits["packed"]
    assert set(packed.DEVICE_COUNTS) == {"packed_segments", "packed_segments_resolved",
                                         "packed_fix_sites", "packed_split_sites"}
    assert {k: rec.counts[k] for k in packed.DEVICE_COUNTS} == dict.fromkeys(
        packed.DEVICE_COUNTS, 0)
    spec = importlib.util.spec_from_file_location(
        "reader_packed_fix_share", ROOT / "benchmark" / "metrics" / "packed_fix_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(profiling, "last_fit", lambda: rec)
    assert mod.read(None) == 0.0


def test_an_smc_fit_counts_no_packed_work(fits):
    rec, n = fits["smc"]
    assert rec.counts["packed_sites"] == rec.counts["packed_ckpt_bytes"] == 0
    assert rec.iterations == FIT["niter"] and not any(n.values())


def test_the_work_tallies_ride_on_a_replay():
    """training.Caller takes a capture's share of the registered tallies
    (profiling.snapshot / since) back and adds it at every replay
    (profiling.replay): the work tallies with the launch counts; a tally
    that counted nothing has no share."""
    packed.reset_counts()
    packed.reset_work()
    A = torch.eye(16)[None].expand(2, 16, 16).contiguous()
    e = torch.full((2, 16), 0.5)
    pi = torch.full((2, 3, 16), 1 / 16)
    obs = torch.zeros(3, 16, dtype=torch.int8)
    before = profiling.snapshot()
    ll, ck = packed.forward(A, e, e, pi, obs, 8, True)
    packed.backward(A, e, e, obs, ck, torch.ones_like(ll), 8)
    share = dict(profiling.since(before))
    n = share[packed.work_tally]
    assert n["packed_sites"] == 2 * 2 * 3 * 16 and n["packed_ckpt_bytes"] == 2 * 2 * 3 * 16 * 4
    assert share[packed.tally] == {"forward_plain": 1, "backward_plain": 1}
    assert smc.tally not in share
    profiling.replay(list(share.items()))
    assert packed.work() == {k: 2 * n[k] for k in packed.WORK_COUNTS}
    assert packed.counts()["forward_plain"] == 2
    packed.reset_work()
    assert packed.work() == dict.fromkeys(packed.WORK_COUNTS, 0)


@pytest.mark.parametrize("overlap", [1, 500])
def test_packed_still_needs_overlap_zero(overlap):
    assert check_backend("packed", 0) == "packed"
    with pytest.raises(ValueError, match="overlap=0"):
        check_backend("packed", overlap)
    with pytest.raises(ValueError, match="overlap=0"):
        mcmc.fit([TRAIN], kernel_backend="packed", overlap=overlap, device="cpu", niter=1)


def test_chip_smoke_packed_genome_phase_rehearsal(monkeypatch, capsys):
    """Phase 12b's gate (chip_smoke.packed_genome_phase) at a small shape, the
    CUDA wrappers replaced by their plain versions in float32 and the
    launches at a plan by the split's plain rendering (4 segments): it
    passes, holds the split to K = 1 at S = 1 and, as the held-out ELPD
    runs B4, at S = 4, and reports the errors as phase 3b does."""
    import chip_smoke

    def fwd32(A, e0, e1, pi, obs, seg_len=packed.DEFAULT_SEG, with_ckpt=True):
        return packed.forward_packed(A, e0, e1, pi, obs, seg_len, with_ckpt)

    def bwd32(A, e0, e1, obs, ckpt, gbar, seg_len=packed.DEFAULT_SEG):
        return packed.backward_packed(A, e0, e1, obs, ckpt, gbar, seg_len)

    counts = dict.fromkeys(packed.DEVICE_COUNTS, 0)

    def add(c):
        for k in counts:
            counts[k] += c[k]

    def launch_fwd(A, e0, e1, pi, obs, with_ckpt, plan=None):
        if plan.K == 1:
            return fwd32(A, e0, e1, pi, obs, with_ckpt=with_ckpt)
        ll, ck, c = packed.forward_segmented(A, e0, e1, pi, obs, plan, with_ckpt)
        add(c)
        return ll, ck

    def launch_bwd(A, e0, e1, obs, ckpt, gbar, plan=None):
        if plan.K == 1:
            return bwd32(A, e0, e1, obs, ckpt, gbar)
        *grads, c = packed.backward_segmented(A, e0, e1, obs, ckpt, gbar, plan)
        add(c)
        return tuple(grads)

    monkeypatch.setattr(packed, "forward_packed_cuda", fwd32)
    monkeypatch.setattr(packed, "backward_packed_cuda", bwd32)
    monkeypatch.setattr(packed, "forward_launch", launch_fwd)
    monkeypatch.setattr(packed, "backward_launch", launch_bwd)
    monkeypatch.setattr(packed, "segment_plan", lambda B, S, L, sms=None, direction="forward":
                        packed.segments(packed.n_segments(L, packed.DEFAULT_SEG), 4))
    monkeypatch.setattr(packed, "reset_device_counts", lambda: counts.update(
        dict.fromkeys(packed.DEVICE_COUNTS, 0)))
    monkeypatch.setattr(packed, "device_counts", lambda: dict(counts))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "PACKED_GENOME_SHAPE", (37, 1, 1003))
    errs = chip_smoke.packed_genome_phase(torch, packed, torch.device("cpu"), "cpu")
    assert 0 < errs["forward"]["ll"] <= 1e-5 and 0 < errs["backward"]["grad"] <= 2e-5
    out = capsys.readouterr().out
    assert ("B=37 S=1 L=1003: split (4, 32) (adjoint (4, 32)) against K = 1: checkpoints and dpi "
            "bitwise equal" in out)
    assert ("B=37 S=4 L=1003 (the ELPD's B4): max rel err ll" in out
            and "split (4, 32) against K = 1: checkpoints bitwise equal, ll the same bits" in out)
    # the counts since the last reset: the ELPD's split forward with checkpoints, then without
    assert counts["packed_segments"] == 2 * 4 * 37 * 4
    assert counts["packed_split_sites"] == 2 * 37 * 4 * 1003
