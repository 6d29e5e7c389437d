"""The structured SMC' ops of phlash_tpu_torch (the plain versions the CPU
runs) against phlash_tpu's scan oracle, its dense kernel and, in interpret
mode, the Pallas kernel bodies themselves (seg_len=32, L=160, S=2, as in
tests/test_smc_kernel.py)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.pallas import tpu as pltpu

from phlash_tpu.hmm import PureXLAKernel, psmc_ll
from phlash_tpu.ops.kernel_dense import DenseKernel
from phlash_tpu.ops.kernel_smc import SMCKernel as JaxSMCKernel
from phlash_tpu.params import PSMCParams as JPSMCParams
from phlash_tpu_torch import convert
from phlash_tpu_torch.ops import smc
from phlash_tpu_torch.ops.kernel_smc import SMCKernel, SMCOp
from phlash_tpu_torch.params import PSMC_FIELDS, PSMCParams
from phlash_tpu_torch.size_history import DemographicModel

L = 160
SEG = 32
PARAMS6 = PSMC_FIELDS[:6]


@pytest.fixture(scope="module")
def sdata():
    "Bernoulli(0.05) rows with a missing block, a missing tail, a padded tail."
    rng = np.random.default_rng(0)
    d = rng.binomial(1, 0.05, size=(4, L)).astype(np.int8)
    d[1, 50:80] = -1
    d[2, 150:] = -1
    d[3, 137:] = -2
    return d


def _pp(M):
    """The default model's parameters at M states, assembled by the port
    (float64; the assembly itself is held against JAX in test_torch_params,
    and eager JAX assembly costs seconds per call on one core)."""
    return PSMCParams.from_dm(DemographicModel.default(pattern=f"{M}*1", theta=1e-2, rho=1e-2))


def _jax_pp(M, dtype):
    return JPSMCParams(**{k: jnp.asarray(v, dtype) for k, v in convert.psmc_fields(_pp(M)).items()})


def _batched(base, B, dtype):
    "Port PSMCParams with (B, M) leaves: B copies, slightly perturbed."
    scale = 1.0 + 0.05 * torch.linspace(0.0, 1.0, B, dtype=torch.float64)[:, None]
    leaves = {k: getattr(base, k).expand(B, -1) * (scale if k in ("b", "u") else 1.0)
              for k in PSMC_FIELDS}
    return base.replace(**{k: v.to(dtype).contiguous() for k, v in leaves.items()})


def _jax_of(tpp, p):
    "Particle p of port params as a reference PSMCParams."
    return JPSMCParams(**{k: jnp.asarray(v[p]) for k, v in convert.psmc_fields(tpp).items()})


def _live(row):
    "The row up to its padding (the JAX oracle reads -2 as an observation)."
    pad = np.flatnonzero(row == -2)
    return row[: pad[0]] if pad.size else row


@pytest.mark.parametrize("M", smc.SUPPORTED_M)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_forward_matches_psmc_ll(sdata, M, dtype):
    """ll and final alpha against phlash_tpu.hmm.psmc_ll: rtol 1e-10 at f64;
    at f32 rtol 1e-5 (ll) and 1e-4 (alpha), the Pallas kernel's gates."""
    tdt = getattr(torch, dtype)
    B, rows = 2, [0, 1, 3]
    tpp = _batched(_pp(M), B, tdt)
    obs = torch.as_tensor(sdata[rows])
    pi = tpp.pi[:, None, :].expand(B, len(rows), M).contiguous()
    ll, alpha, pst = smc.forward_structured([getattr(tpp, k) for k in PARAMS6], pi, obs, True)
    assert pst.shape == (smc.n_periods(L), len(rows), B, M)
    rtol_ll, rtol_a = (1e-10, 1e-10) if dtype == "float64" else (1e-5, 1e-4)
    for p in range(B):
        jpp = _jax_of(tpp, p)
        for s, r in enumerate(rows):
            a_want, ll_want = psmc_ll(jpp, jnp.asarray(_live(sdata[r])))
            np.testing.assert_allclose(ll[p, s].item(), float(ll_want), rtol=rtol_ll)
            np.testing.assert_allclose(alpha[p, s].numpy(), np.asarray(a_want), rtol=rtol_a,
                                       atol=1e-25)


def test_scan_oracle_matches_jax(sdata):
    """The port's psmc_ll (hmm.py) against phlash_tpu.hmm.psmc_ll at f64:
    values and final state rtol 1e-10, gradients w.r.t. every leaf rtol
    1e-8, on rows with missing data; a padded tail freezes the state."""
    from phlash_tpu_torch.hmm import psmc_ll as torch_psmc_ll

    tpp = _pp(16)
    row = sdata[1]
    jpp = JPSMCParams(**{k: jnp.asarray(v) for k, v in convert.psmc_fields(tpp).items()})
    a_j, ll_j = psmc_ll(jpp, jnp.asarray(row))
    g_j = jax.grad(lambda p: psmc_ll(p, jnp.asarray(row))[1])(jpp)
    leaves = {k: getattr(tpp, k).clone().requires_grad_(True) for k in PSMC_FIELDS}
    a_t, ll_t = torch_psmc_ll(tpp.replace(**leaves), torch.as_tensor(row))
    np.testing.assert_allclose(ll_t.item(), float(ll_j), rtol=1e-10)
    np.testing.assert_allclose(a_t.detach().numpy(), np.asarray(a_j), rtol=1e-10)
    g_t = torch.autograd.grad(ll_t, list(leaves.values()))
    for name, a, b in zip(PSMC_FIELDS, g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, err_msg=name)
    padded = torch.as_tensor(sdata[3])
    a_p, ll_p = torch_psmc_ll(tpp, padded)
    a_l, ll_l = torch_psmc_ll(tpp, torch.as_tensor(_live(sdata[3])))
    assert float(ll_p) == float(ll_l) and torch.equal(a_p, a_l)


def _random_case(B, S, Lr, M, seed):
    "f64 params / pi / rows (missing block, padding) and both cotangents."
    rng = np.random.default_rng(seed)
    tpp = _batched(_pp(M), B, torch.float64)
    params = [getattr(tpp, k) for k in PARAMS6]
    pi = torch.as_tensor(rng.dirichlet(np.ones(M), size=(B, S)))
    obs = torch.as_tensor(rng.binomial(1, 0.1, size=(S, Lr)).astype(np.int8))
    obs[0, 3:9] = -1
    obs[-1, Lr - 5:] = -2
    gbar = torch.as_tensor(rng.standard_normal((B, S)))
    abar0 = torch.as_tensor(rng.standard_normal((B, S, M)))
    return params, pi, obs, gbar, abar0


def test_plain_backward_matches_autograd():
    "The hand adjoint equals torch.autograd through the plain forward (f64)."
    params, pi, obs, gbar, abar0 = _random_case(3, 3, 45, 16, seed=1)
    leaves = [x.clone().requires_grad_(True) for x in (*params, pi)]
    ll, alpha, _ = smc.forward_structured(leaves[:6], leaves[6], obs, False)
    want = torch.autograd.grad((ll * gbar).sum() + (alpha * abar0).sum(), leaves)
    _, _, pst = smc.forward_structured(params, pi, obs, True)
    dparams, dpi = smc.backward_structured(params, obs, pst, gbar, abar0)
    got = [g.sum(1) for g in dparams] + [dpi]
    for name, a, b in zip(PSMC_FIELDS, got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-12, err_msg=name)


def test_smc_op_gradcheck():
    "torch.autograd.gradcheck on the autograd.Function (both outputs)."
    params, pi, obs, _, _ = _random_case(2, 2, 13, 8, seed=2)
    leaves = [x.clone().requires_grad_(True) for x in (*params, pi)]
    assert torch.autograd.gradcheck(lambda *xs: SMCOp.apply(obs, True, False, *xs), leaves)


def test_grads_match_dense_kernel(sdata):
    """Gradients of a weighted ll sum at f32 against phlash_tpu's DenseKernel:
    normalized atol 2e-5 (the gate of tests/test_smc_kernel.py)."""
    B, S, inds = 3, 2, [0, 1]
    jpp32 = _jax_pp(16, jnp.float32)
    W = np.arange(1.0, B * S + 1).reshape(B, S)
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, S) + a.shape), jpp32)
    dkern = DenseKernel(M=16, data=sdata[:3], seg_len=SEG)
    gd = jax.grad(lambda p: (dkern.loglik_batched(p, jnp.array(inds)) * W).sum())(pps)

    kern = SMCKernel(16, sdata[:3], device="cpu")
    tpp = convert.from_reference_psmc(jpp32, dtype=torch.float32)
    leaves = {k: getattr(tpp, k).expand(B, -1).clone().requires_grad_(True) for k in PARAMS6}
    pi = tpp.pi.expand(B, S, -1).clone().requires_grad_(True)
    ll = kern.loglik_batched(tpp.replace(pi=pi, **leaves), torch.tensor(inds))
    gt = torch.autograd.grad((ll * torch.as_tensor(W, dtype=torch.float32)).sum(),
                             [*leaves.values(), pi])
    for name, a, b in zip(PSMC_FIELDS, gt, gd):
        b = np.asarray(b)
        if name != "pi":
            b = b.sum(1)
        denom = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a.numpy() / denom, b / denom, atol=2e-5, err_msg=name)


def test_matches_pallas_kernel_interpret(sdata):
    """Values and gradients against the Pallas forward-with-residuals (B2)
    and adjoint (B3) bodies in interpret mode, at f32: ll rtol 1e-5, all
    seven gradients normalized atol 2e-5."""
    B, S, inds = 3, 2, [0, 1]
    jpp32 = _jax_pp(16, jnp.float32)
    W = jnp.arange(1.0, B * S + 1, dtype=jnp.float32).reshape(B, S)
    rng = np.random.default_rng(3)
    pi_np = rng.dirichlet(np.ones(16), size=(B, S)).astype(np.float32)
    pps = jax.tree.map(lambda a: jnp.broadcast_to(a, (B, S) + a.shape), jpp32)._replace(
        pi=jnp.asarray(pi_np))
    jkern = JaxSMCKernel(M_=16, data=sdata[:2], seg_len=SEG)

    def loss(p):
        ll = jkern.loglik_batched(p, jnp.array(inds))
        return (ll * W).sum(), ll

    with pltpu.force_tpu_interpret_mode():
        (_, ll_j), g_j = jax.value_and_grad(loss, has_aux=True)(pps)

    kern = SMCKernel(16, sdata[:2], device="cpu")
    tpp = convert.from_reference_psmc(jpp32, dtype=torch.float32)
    leaves = {k: getattr(tpp, k).expand(B, -1).clone().requires_grad_(True) for k in PARAMS6}
    pi = torch.tensor(pi_np, requires_grad=True)
    ll = kern.loglik_batched(tpp.replace(pi=pi, **leaves), torch.tensor(inds))
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(ll_j), rtol=1e-5)
    gt = torch.autograd.grad((ll * torch.tensor(np.asarray(W))).sum(), [*leaves.values(), pi])
    for name, a, b in zip(PSMC_FIELDS, gt, g_j):
        b = np.asarray(b)
        if name != "pi":
            b = b.sum(1)
        denom = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a.numpy() / denom, b / denom, atol=2e-5, err_msg=name)


def test_filter_matches_oracle_and_grads(sdata):
    """filter_batched: final states against psmc_ll (f64, rtol 1e-10), and
    gradients through the final-state cotangent against phlash_tpu's scan
    kernel filter (f64, normalized atol 1e-9)."""
    B = 2
    tpp = _batched(_pp(16), B, torch.float64)
    warmup = sdata[:2]
    kern = SMCKernel(16, sdata, device="cpu")
    alpha = kern.filter_batched(tpp, torch.as_tensor(warmup))
    assert alpha.shape == (B, 2, 16)
    for p in range(B):
        for s in range(2):
            want = psmc_ll(_jax_of(tpp, p), jnp.asarray(warmup[s]))[0]
            np.testing.assert_allclose(alpha[p, s].numpy(), np.asarray(want), rtol=1e-10)

    T = np.linspace(0.5, 1.5, B * 2 * 16).reshape(B, 2, 16)
    xkern = PureXLAKernel(M=16, data=sdata, double_precision=True)
    jpps = JPSMCParams(**{k: jnp.asarray(v) for k, v in convert.psmc_fields(tpp).items()})
    gx = jax.grad(lambda p: (xkern.filter_batched(p, jnp.asarray(warmup)) * T).sum())(jpps)
    leaves = {k: getattr(tpp, k).clone().requires_grad_(True) for k in PSMC_FIELDS}
    out = kern.filter_batched(tpp.replace(**leaves), torch.as_tensor(warmup))
    gt = torch.autograd.grad((out * torch.as_tensor(T)).sum(), list(leaves.values()))
    for name, a, b in zip(PSMC_FIELDS, gt, gx):
        b = np.asarray(b)
        denom = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a.numpy() / denom, b / denom, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("Lr", [40, 45])
def test_pstates_are_chunk_major_period_states(Lr):
    """pstates[q, s, p] is instance (p, s)'s state at the start of period q:
    the final state of the forward over the row's first 8q sites (the
    layout the CUDA kernels write and read)."""
    params, pi, obs, _, _ = _random_case(3, 2, Lr, 8, seed=5)
    _, alpha, pst = smc.forward_structured(params, pi, obs, True)
    assert pst.shape == (smc.n_periods(Lr), 2, 3, 8)
    torch.testing.assert_close(pst[0], pi.transpose(0, 1), rtol=0, atol=0)
    for q in range(1, smc.n_periods(Lr)):
        _, a_q, _ = smc.forward_structured(params, pi, obs[:, : q * smc.NORM_EVERY], False)
        torch.testing.assert_close(pst[q], a_q.transpose(0, 1), rtol=1e-12, atol=0)


def test_states_per_lane_and_geometry():
    """The kernels' mapping as csrc/smc_common.cuh states it: one states-per-
    lane instance for each supported M (as ops/smc.STATES_PER_LANE has it),
    groups of 4 to 32 lanes, and the split path's checkpoint interval
    (CHECK_PERIODS); at the fit shape (B=500, S=5, M=16) 4-lane groups, 8
    instances a warp, one-warp blocks.  kernel_geometry refuses an M with no
    kernel before it builds."""
    import re
    from pathlib import Path

    header = (Path(smc.__file__).parents[1] / "csrc" / "smc_common.cuh").read_text()
    mapping = re.search(r"#define PHLASH_SMC_INSTANCES\(X\) (.*)", header).group(1)
    spl = {int(m): int(s) for m, s in re.findall(r"X\((\d+), (\d+)\)", mapping)}
    per_block = int(re.search(r"INSTANCES_PER_BLOCK = (\d+);", header).group(1))
    assert tuple(spl) == smc.SUPPORTED_M
    assert spl == smc.STATES_PER_LANE and per_block == smc.INSTANCES_PER_BLOCK
    check_every = int(re.search(r"constexpr int CHECK_EVERY = (\d+);", header).group(1))
    assert check_every == smc.CHECK_PERIODS
    for M, s in spl.items():
        lanes = M // s
        assert M % s == 0 and 4 <= lanes <= 32 and lanes & (lanes - 1) == 0
    geo = smc.launch_geometry(500, 5, 16, spl[16], per_block)
    assert geo == dict(states_per_lane=4, lanes_per_instance=4, instances_per_warp=8,
                       threads_per_block=32, blocks=315, warps=315)
    with pytest.raises(ValueError, match="support M"):
        smc.kernel_geometry(500, 5, 24)


def test_split_adjoint_cache_fits_its_residency():
    """The split adjoint's shared memory as csrc states it: a block's period
    cache (x, S(x) and P(u x) at each of a period's sites, SPL floats a lane,
    a slice a warp) beside the observation tile, plus the 1 KB the card
    reserves a block, times the blocks ADJOINT_WARPS_PER_SM asks for, fits
    the H100's 227 KB at every PHLASH_SMC_INSTANCES entry (12 KB a one-warp
    block at M = 16); the three split kernels' shared-cache instances are
    bound to that many blocks, their register-cache ones and the unsplit
    kernel are not; and the plan's target is the header's."""
    import re
    from pathlib import Path

    csrc = Path(smc.__file__).parents[1] / "csrc"
    header, source = (csrc / "smc_common.cuh").read_text(), (csrc / "smc_backward.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", header).group(1))

    mapping = re.search(r"#define PHLASH_SMC_INSTANCES\(X\) (.*)", header).group(1)
    spl = {int(m): int(s) for m, s in re.findall(r"X\((\d+), (\d+)\)", mapping)}
    arrays = int(re.search(r"enum CacheArray \{[^}]*CACHE_ARRAYS = (\d+) \}", header).group(1))
    tile = re.search(r"__shared__ __align__\(16\) int8_t sh\[OBS_TILE \+ (\d+)\]", source)
    warps, per_block = const("ADJOINT_WARPS_PER_SM"), const("INSTANCES_PER_BLOCK")
    assert warps == smc.TARGET_WARPS_PER_SM["adjoint"] and arrays == 3
    for M, s in spl.items():
        threads = per_block * M // s
        cache = threads // 32 * const("NORM_EVERY") * arrays * 32 * s * 4
        blocks = warps * 32 // threads
        assert blocks * (cache + const("OBS_TILE") + int(tile.group(1)) + 1024) <= 227 * 1024, M
        if M == 16:
            assert threads == 32 and cache == 12 * 1024 and blocks == 16
    assert re.search(r"MIN_BLOCKS = ADJOINT_WARPS_PER_SM \* 32 / THREADS;", source)
    for kind in ("speculate", "fix", "splice"):
        assert re.search(r"template <int M, int SPL, bool SHARED>\n__global__ void __launch_bounds__"
                         r"\(AdjointSplit<M, SPL>::THREADS,\s+SHARED \? AdjointSplit<M, SPL>::"
                         rf"MIN_BLOCKS : 1\)\nsmc_backward_kernel_{kind}\(", source), kind
    assert "__launch_bounds__(Group<M, SPL>::THREADS)\nsmc_backward_kernel(" in source


def test_dispatch_by_device():
    "CPU tensors take the plain versions and count as such; nothing launches."
    params, pi, obs, gbar, abar0 = _random_case(2, 2, 20, 8, seed=4)
    smc.reset_counts()
    _, _, pst = smc.forward(params, pi, obs, True)
    smc.backward(params, obs, pst, gbar, abar0)
    assert smc.counts() == dict(forward_cuda=0, forward_cuda_residuals=0, backward_cuda=0,
                                forward_plain=1, backward_plain=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        smc.forward_cuda([p.float() for p in params], pi.float(), obs, True)
    with pytest.raises(ValueError, match="support M"):
        SMCKernel(24, np.zeros((1, 8), np.int8), device="cpu")


# The split path's plain rendering (forward_segmented / backward_segmented)
# against the unsplit plain versions.  (B, S, L, K, dtype, theta = rho, het
# rate, all missing): rows that forget their start within a few hundred
# sites, in float32 and float64; all-missing rows with a tiny recombination
# rate, where no fix chain meets and the splice re-runs segment after
# segment; and more segments asked for than the row has checkpoint
# intervals (38 periods: 3 intervals of 16).
SPLIT_CASES = {
    "mixes_f32": (3, 2, 3000, 6, torch.float32, 0.1, 0.1, False),
    "mixes_f64": (3, 2, 6000, 6, torch.float64, 0.1, 0.1, False),
    "never_meets": (3, 2, 2000, 4, torch.float64, 1e-9, 0.1, True),
    "k_past_intervals": (3, 2, 300, 50, torch.float64, 1e-2, 0.1, False),
}


def _split_case(B, S, Lr, dtype, rho, het, missing, seed=11):
    "Params at theta = 0.1, rho; random pi; rows at the het rate (or all missing), a padded tail."
    rng = np.random.default_rng(seed)
    base = PSMCParams.from_dm(DemographicModel.default(pattern="16*1", theta=0.1, rho=rho))
    tpp = _batched(base, B, torch.float64)
    params = [getattr(tpp, k).to(dtype).contiguous() for k in PARAMS6]
    pi = torch.as_tensor(rng.dirichlet(np.ones(16), size=(B, S))).to(dtype)
    obs = torch.as_tensor(rng.binomial(1, het, size=(S, Lr)).astype(np.int8))
    if missing:
        obs[:] = -1
    obs[-1, Lr - 5:] = -2
    gbar = torch.as_tensor(rng.standard_normal((B, S))).to(dtype)
    abar0 = torch.as_tensor(rng.standard_normal((B, S, 16))).to(dtype)
    return params, pi, obs, gbar, abar0


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_plan_matches_the_unsplit_plain_versions(case):
    """The split forward's pstates and alpha are the unsplit forward's bit for
    bit; ll and the adjoint's gradients equal the unsplit ones to rounding
    (float64: 1e-12 of max; float32: within the card's gates of the float64
    unsplit values, rtol 1e-5 and 2e-5 of max); the counts say what ran."""
    B, S, Lr, K, dtype, rho, het, missing = SPLIT_CASES[case]
    params, pi, obs, gbar, abar0 = _split_case(B, S, Lr, dtype, rho, het, missing)
    plan = smc.segments(smc.n_periods(Lr), K)
    ll, alpha, pst = smc.forward_structured(params, pi, obs, True)
    ll_s, alpha_s, pst_s, fwd = smc.forward_segmented(params, pi, obs, True, smc.Plan(K, 0))
    assert torch.equal(pst_s, pst) and torch.equal(alpha_s, alpha)
    _, alpha_1, none, _ = smc.forward_segmented(params, pi, obs, False, smc.Plan(K, 0))
    assert none is None and torch.equal(alpha_1, alpha)
    grads, dpi = smc.backward_structured(params, obs, pst, gbar, abar0)
    grads_s, dpi_s, bwd = smc.backward_segmented(params, obs, pst, gbar, abar0, smc.Plan(K, 0))
    if dtype == torch.float64:
        want_ll, want = ll, (*grads, dpi)
        ll_tol, grad_tol = 1e-12, 1e-12
    else:
        p64 = [x.double() for x in params]
        ll64, _, pst64 = smc.forward_structured(p64, pi.double(), obs, True)
        g64, dpi64 = smc.backward_structured(p64, obs, pst64, gbar.double(), abar0.double())
        want_ll, want = ll64, (*g64, dpi64)
        ll_tol, grad_tol = 1e-5, 2e-5
    np.testing.assert_allclose(ll_s.double().numpy(), want_ll.double().numpy(), rtol=ll_tol)
    for name, got, ref in zip(("b", "d", "u", "v", "emis0", "emis1", "pi"), (*grads_s, dpi_s),
                              want):
        err = float((got.double() - ref.double()).abs().max())
        assert err <= grad_tol * (float(ref.abs().max()) + 1e-300), (name, err)
    n_inst = B * S
    for c in (fwd, bwd):
        assert c["smc_segments"] == plan.K * n_inst and c["smc_split_sites"] == n_inst * Lr
        assert 0 <= c["smc_segments_resolved"] <= (plan.K - 1) * n_inst
    if case.startswith("mixes"):  # most fix chains meet inside their own segment
        for c in (fwd, bwd):
            assert c["smc_segments_resolved"] >= (plan.K - 1) * n_inst // 2
            assert 0 < c["smc_fix_sites"] < c["smc_split_sites"]
    elif case == "never_meets":  # no fix meets; the splice re-runs segments 2 .. K-1 whole
        assert fwd["smc_segments_resolved"] == 0
        seg_sites = plan.periods * smc.NORM_EVERY
        assert fwd["smc_fix_sites"] == n_inst * ((Lr - seg_sites) + (Lr - 2 * seg_sites))
    else:
        assert plan == smc.Plan(3, 16)


@pytest.mark.parametrize("direction", ["forward", "adjoint"])
def test_segment_plan(direction):
    """K = 1 at the short cell's shapes (chunks of 500 + 100), for the
    warm-up filter and on a card the instances already fill; K >= 2 along a
    genome's rows, as many as fill the direction's TARGET_WARPS_PER_SM a SM;
    segments of whole checkpoint intervals, none empty and none under
    MIN_SEGMENT_SITES sites (but the last)."""
    sms, resident = 132, 16  # the H100's SMs, the warps an SM its split adjoint holds
    target = smc.TARGET_WARPS_PER_SM[direction]
    for B, S, L in ((500, 5, 600), (500, 5, 100), (500, 5, 500), (500, 40, 94_000),
                    (500, 5, 2000), (1, 1, smc.MIN_SEGMENT_SITES * 2 - 1)):
        assert smc.segment_plan(B, S, L, 16, sms, direction, resident).K == 1, (B, S, L)
    for B, S, L in ((500, 1, 94_000), (500, 5, 94_000), (500, 4, 94_000), (32, 1, 5_000),
                    (500, 1, 93_999), (1, 1, 10**6)):
        n_per = smc.n_periods(L)
        K, P = smc.segment_plan(B, S, L, 16, sms, direction, resident)
        assert K >= 2 and P % smc.CHECK_PERIODS == 0 and (K - 1) * P < n_per <= K * P
        assert P * smc.NORM_EVERY >= smc.MIN_SEGMENT_SITES
        warps = smc.launch_geometry(B, S, 16, smc.STATES_PER_LANE[16], smc.INSTANCES_PER_BLOCK)
        assert K * warps["warps"] <= target * sms
    want = {"forward": smc.Plan(32, 368), "adjoint": smc.Plan(32, 368)}[direction]
    assert smc.segment_plan(500, 1, 94_000, 16, sms, direction, resident) == want
    assert smc.segments(100, 1) == smc.Plan(1, 100) and smc.segments(20, 8) == smc.Plan(2, 16)
