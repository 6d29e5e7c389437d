"""The SVGD update of phlash_tpu_torch: the exact median selection against
phlash_tpu's and against the sort, the row-block direction, the update's
dispatch and counters, and chip_smoke.py phase 15's gate rehearsed with
stand-ins for the hand kernels S1-S3 (ops/svgd.py)."""

import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: the row-block matmuls sum as the full ones

import jax.numpy as jnp
import numpy as np

from phlash_tpu.svgd import _offdiag_median_select as jax_select
from phlash_tpu_torch.ops import svgd as ops_svgd
from phlash_tpu_torch.svgd import (SVGD, AMSGrad, AMSGradState, median_bandwidth,
                                   offdiag_median_select, svgd_direction, update_plain)

PS = (2, 3, 8, 37, 500)
KINDS = ("random", "ties", "duplicates", "degenerate")


def _cloud(kind: str, P: int, D: int = 18, seed: int = 0) -> np.ndarray:
    """float64 (P, D): random N(0, 1); ties: every particle twice; duplicates:
    coordinates on a grid of 1/4 (many equal distances); degenerate: P
    copies of one particle (every distance 0)."""
    x = np.random.default_rng(seed).normal(size=(P, D))
    if kind == "ties":
        x = x[np.arange(P) // 2]
    elif kind == "duplicates":
        x = np.round(4 * x) / 4
    elif kind == "degenerate":
        x = np.repeat(x[:1], P, 0)
    return x


def _distances(x: np.ndarray, dtype) -> np.ndarray:
    "The (P, P) Euclidean distances in `dtype`, as phlash_tpu's median_bandwidth takes them."
    xt = torch.as_tensor(x, dtype=dtype)
    return torch.sqrt(((xt[:, None] - xt[None]) ** 2).sum(-1)).numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", PS)
def test_select_matches_jax_bitwise(P, kind):
    """The port's offdiag_median_select against phlash_tpu's
    _offdiag_median_select (JAX on the CPU, as tests/test_svgd.py runs it),
    float32 (the dtype phlash_tpu selects in), bit for bit."""
    d = _distances(_cloud(kind, P, seed=P), torch.float32)
    want = np.asarray(jax_select(jnp.asarray(d), P))
    got = offdiag_median_select(torch.as_tensor(d), P).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes(), (got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", PS)
def test_select_matches_sort_bitwise(P, kind, dtype):
    """The selection's h against median_bandwidth's sort, bitwise, in float32
    and float64; the degenerate cloud takes the 1e-12 floor."""
    x = torch.as_tensor(_cloud(kind, P, seed=P + 1), dtype=dtype)
    sq = ((x[:, None] - x[None]) ** 2).sum(-1)
    want = median_bandwidth(sq, P)
    med = offdiag_median_select(torch.sqrt(sq), P)
    got = torch.clamp_min(med**2 / math.log(P), 1e-12)
    assert torch.equal(got, want), (got, want)
    if kind == "degenerate":
        assert want.item() == torch.tensor(1e-12, dtype=dtype).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P, rows", [(500, slice(125, 250)), (48, slice(12, 24)),
                                     (37, slice(0, 9)), (8, slice(4, 8))])
def test_direction_rows_are_the_full_directions_block(P, rows, dtype):
    "svgd_direction at a mesh block's rows is that block of the full direction, bitwise."
    rng = np.random.default_rng(P)
    x = torch.as_tensor(rng.normal(size=(P, 18)), dtype=dtype)
    g = torch.as_tensor(rng.normal(size=(P, 18)), dtype=dtype)
    assert torch.equal(svgd_direction(x, g, rows), svgd_direction(x, g)[rows])


def _step_inputs(P=8, D=5, seed=3):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(P, D)))
    g = torch.as_tensor(rng.normal(size=(P, D)))
    g[2, 1], g[5] = math.inf, math.nan
    return x, g


def test_cpu_step_is_the_plain_update_and_counts_plain_calls():
    """A CPU step runs the plain update (mask, direction, amsgrad) bit for
    bit, calls each plain version once and launches nothing."""
    x, g = _step_inputs()
    opt = AMSGrad(learning_rate=0.1)
    svgd = SVGD(lambda flat, **kw: g.clone(), opt)
    state = svgd.init(x)
    ops_svgd.reset_counts()
    got = svgd.step(state)
    assert ops_svgd.counts() == dict(distances_cuda=0, bandwidth_cuda=0, update_cuda=0,
                                     bandwidth_plain=1, direction_plain=1, amsgrad_plain=1)
    gm = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    updates, o = opt.update(-svgd_direction(x, gm), state.opt_state)
    want = (x + updates, o.mu, o.nu, o.nu_max, o.count)
    for a, b, c in zip(got.tensors(), want, update_plain(x, g, slice(None), state.opt_state,
                                                         opt)):
        assert torch.equal(a, b) and torch.equal(c, b)


def test_cpu_meshed_step_moves_its_rows():
    "With a gather, a CPU step moves its block along the full cloud's rows of the direction."
    x, g = _step_inputs()
    rows = slice(2, 6)
    opt = AMSGrad(learning_rate=0.1)
    full = SVGD(lambda flat, **kw: g.clone(), opt)
    block = SVGD(lambda flat, **kw: g[rows].clone(), opt, gather=lambda p, gr: (x, g, rows))
    want = full.step(full.init(x))
    got = block.step(block.init(x[rows].clone()))
    for a, b in zip(got.tensors()[:4], want.tensors()[:4]):
        assert torch.equal(a, b[rows])


def test_cuda_wrappers_refuse_cpu_tensors():
    """S1-S3's wrappers take CUDA tensors only: a CPU tensor raises before any
    launch or build, as it does in a process without a card; a step on
    another device type raises too."""
    x, g = _step_inputs()
    o = AMSGrad(learning_rate=0.1).init(x)
    ops_svgd.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops_svgd.distances_cuda(x, g)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops_svgd.bandwidth_cuda(torch.zeros(ops_svgd.pairs(8), dtype=x.dtype),
                                torch.zeros(3, dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops_svgd.update_cuda(x, x.t().contiguous(), g.t().contiguous(),
                             torch.ones((), dtype=x.dtype),
                             slice(None), o.mu, o.nu, o.nu_max, o.count,
                             AMSGrad(learning_rate=0.1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops_svgd.step_cuda(x, g, slice(None), o, AMSGrad(learning_rate=0.1))
    svgd = SVGD(lambda flat, **kw: torch.zeros_like(flat), AMSGrad(learning_rate=0.1))
    with pytest.raises(ValueError, match="no SVGD update"):
        svgd.step(svgd.init(x.to("meta")))
    assert ops_svgd.counts() == dict.fromkeys(ops_svgd.counts(), 0)


def test_radix_is_the_kernels():
    """ops/svgd.RADIX, by which chip_smoke checks S1's first digit, and
    ops/svgd.SELECT_BLOCKS, by which bandwidth_cuda sizes S2's offsets, are
    csrc/svgd.cu's."""
    import re
    from pathlib import Path

    src = (Path(ops_svgd.__file__).parent.parent / "csrc" / "svgd.cu").read_text()
    for name in ("RADIX", "SELECT_BLOCKS"):
        want = int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
        assert want == getattr(ops_svgd, name), name


def test_counts_add_and_reset():
    "add_counts adds a counts() dict (a graph replay's), reset_counts zeroes every counter."
    ops_svgd.reset_counts()
    n = dict(distances_cuda=2, bandwidth_cuda=2, update_cuda=2, bandwidth_plain=1,
             direction_plain=1, amsgrad_plain=1)
    ops_svgd.add_counts(n)
    ops_svgd.add_counts(n)
    assert ops_svgd.counts() == {k: 2 * v for k, v in n.items()}
    ops_svgd.reset_counts()
    assert ops_svgd.counts() == dict.fromkeys(n, 0)


# PERF.md's table of S1-S3 at the fit's cloud (P = 500, D = 18, float32)
@pytest.mark.parametrize("name, bound_ms, by", [
    ("svgd_distances", "0.000192", "bytes"),
    ("svgd_bandwidth", "0.000149", "bytes"),
    ("svgd_update", "0.000547", "operations"),
])
def test_roofline_reproduces_the_update_rows(name, bound_ms, by):
    "Each update kernel's bound, to 3 significant figures, and what bounds it."
    from phlash_tpu_torch import roofline

    ms, got_by = roofline.svgd_bound(name, 500, 18)
    assert f"{ms:.3g}" == bound_ms and got_by == by


def test_roofline_update_counts():
    """S3's work scales with the rows it moves, float64 counts against the
    float64 peak, and an unknown kernel is refused."""
    from phlash_tpu_torch import roofline

    full = roofline.svgd_bound("svgd_update", 500, 18)[0]
    assert roofline.svgd_bound("svgd_update", 500, 18, B=125)[0] == pytest.approx(full / 4,
                                                                                   rel=1e-3)
    f64 = roofline.svgd_bound("svgd_update", 500, 18, elem=8)[0]
    assert f64 == pytest.approx(full * roofline.PEAK_FP32 / roofline.PEAK_FP64)
    with pytest.raises(ValueError, match="unknown SVGD kernel"):
        roofline.svgd_bound("svgd", 500, 18)


class _StandIns:
    """S1-S3 as the kernels compute them, in PyTorch on the CPU: distances
    in double rounded to the dtype; h by median_bandwidth's sort (S2 is
    bitwise the sort's); K, the sums of K g and K (x_j - x_r) in double,
    amsgrad in the dtype.  For rehearsing chip_smoke.check_svgd here."""

    @staticmethod
    def distances_cuda(x, g):
        P = x.shape[0]
        i, j = torch.tril_indices(P, P, -1)
        xd = x.double()
        tri = ((xd[i] - xd[j]) ** 2).sum(-1).to(x.dtype)
        import chip_smoke

        gm = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        return (tri, x.t().contiguous(), gm.t().contiguous(),
                torch.tensor(chip_smoke.svgd_first_digit(torch, tri)))

    @staticmethod
    def bandwidth_cuda(tri, sel, P):
        import chip_smoke

        return median_bandwidth(chip_smoke.tri_matrix(torch, tri, P), P)

    @staticmethod
    def update_cuda(x, xt, gt, h, rows, mu, nu, nu_max, count, opt):
        xd, P = x.double(), x.shape[0]
        diff = xd[None] - xd[rows][:, None]  # (B, P, D): x_j - x_r
        K = torch.exp(-(diff**2).sum(-1) / h.double())
        att = K @ gt.double().t()
        rep = (K[:, :, None] * diff).sum(1)
        phi = ((att - (2.0 / h.double()) * rep) / P).to(x.dtype)
        upd, o = opt.update(-phi, AMSGradState(mu, nu, nu_max, count))
        return x[rows] + upd, o.mu, o.nu, o.nu_max, o.count


def test_chip_smoke_svgd_gate_rehearsal():
    """chip_smoke.check_svgd's cases and gates, on the CPU with _StandIns in
    place of the kernels: every case passes its gate (so a kernel that
    computes what the stand-ins compute passes it on the card), at P = 37,
    8, 3 and 2 (the card also runs 500, 48 and 32)."""
    import chip_smoke

    out = chip_smoke.check_svgd(torch, torch.device("cpu"), _StandIns, ps=(37, 8, 3, 2))
    assert out["cases"] == 4 * len(chip_smoke.SVGD_DS) * len(chip_smoke.SVGD_KINDS) * 2 * 2
    assert out["state"]["float32"] <= chip_smoke.SVGD_RTOL["float32"]
    assert out["repeats"] == 2 * chip_smoke.SVGD_REPEATS  # no side streams on the CPU


def test_chip_smoke_svgd_repeats_fail_a_drifting_bandwidth():
    """chip_smoke.svgd_repeats fails when one of S2's repeated launches
    differs from the first in its last bit (a race in the selection would)."""
    import chip_smoke

    class Drifting(_StandIns):
        calls = 0

        @classmethod
        def bandwidth_cuda(cls, tri, sel, P):
            cls.calls += 1
            h = _StandIns.bandwidth_cuda(tri, sel, P)
            return torch.nextafter(h, h + 1) if cls.calls == 100 else h

    gen = torch.Generator().manual_seed(0)
    with pytest.raises(SystemExit):
        chip_smoke.svgd_repeats(torch, Drifting, torch.device("cpu"), gen, 37, 18)


def test_chip_smoke_expected_counts_include_the_update():
    "Every fit iteration on the card launches S1, S2 and S3 once (expected_counts)."
    import chip_smoke

    for backend in ("smc", "packed"):
        want = chip_smoke.expected_counts(backend, 30)
        steps = want["assembly"]["backward_cuda"]
        assert want["svgd"] == dict(distances_cuda=steps, bandwidth_cuda=steps,
                                    update_cuda=steps, bandwidth_plain=0, direction_plain=0,
                                    amsgrad_plain=0)


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    "S1-S3 against their plain versions on a card (chip_smoke.py phase 15 runs this check)."
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 15 runs this check on the card")
    import chip_smoke

    chip_smoke.check_svgd(torch, torch.device("cuda", 0))
