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
    assert torch.autograd.gradcheck(lambda *xs: SMCOp.apply(obs, True, *xs), leaves)


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
    lane instance for each supported M, groups of 4 to 32 lanes; at the fit
    shape (B=500, S=5, M=16) 4-lane groups, 8 instances a warp, one-warp
    blocks.  kernel_geometry refuses an M with no kernel before it builds."""
    import re
    from pathlib import Path

    header = (Path(smc.__file__).parents[1] / "csrc" / "smc_common.cuh").read_text()
    mapping = re.search(r"#define PHLASH_SMC_INSTANCES\(X\) (.*)", header).group(1)
    spl = {int(m): int(s) for m, s in re.findall(r"X\((\d+), (\d+)\)", mapping)}
    per_block = int(re.search(r"INSTANCES_PER_BLOCK = (\d+);", header).group(1))
    assert tuple(spl) == smc.SUPPORTED_M
    for M, s in spl.items():
        lanes = M // s
        assert M % s == 0 and 4 <= lanes <= 32 and lanes & (lanes - 1) == 0
    geo = smc.launch_geometry(500, 5, 16, spl[16], per_block)
    assert geo == dict(states_per_lane=4, lanes_per_instance=4, instances_per_warp=8,
                       threads_per_block=32, blocks=315, warps=315)
    with pytest.raises(ValueError, match="support M"):
        smc.kernel_geometry(500, 5, 24)


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
