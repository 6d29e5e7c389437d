"""The dense-transition path of phlash_tpu_torch against phlash_tpu: the
plain versions of the packed kernels (B4 forward, B5 adjoint) that the CPU
runs, the autograd wrapper and module around them, the plain dense kernel
and `dense_transition`, held to phlash_tpu's PallasKernel (interpret mode),
its DenseKernel and its log density, with missing data and padding."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.pallas import tpu as pltpu

from phlash_tpu.model import log_density_batched as jax_log_density
from phlash_tpu.ops.kernel_dense import DenseKernel as JaxDenseKernel
from phlash_tpu.ops.kernel_pallas import PallasKernel
from phlash_tpu.ops.packing import dense_transition as jax_dense_transition
from phlash_tpu.params import PSMCParams as JPSMCParams

import phlash_tpu_torch
from phlash_tpu_torch import convert
from phlash_tpu_torch.kernel import get_kernel
from phlash_tpu_torch.model import log_density_batched
from phlash_tpu_torch.ops import packed
from phlash_tpu_torch.ops.kernel_dense import DenseKernel
from phlash_tpu_torch.ops.kernel_packed import PackedKernel, PackedOp
from phlash_tpu_torch.ops.packing import dense_transition
from phlash_tpu_torch.params import PSMC_FIELDS, PSMCParams
from phlash_tpu_torch.size_history import DemographicModel
from phlash_tpu_torch.training import batched_grad

M = 16
PARAMS6 = PSMC_FIELDS[:6]
B, S, INDS = 3, 2, [0, 1]


@pytest.fixture(scope="module")
def short_data():
    "4 rows x 300 Bernoulli(0.05) sites with a missing stretch (tests/test_pallas.py)."
    d = np.random.default_rng(1).binomial(1, 0.05, size=(4, 300)).astype(np.int8)
    d[1, 50:80] = -1
    return d


def _batched(dtype) -> PSMCParams:
    """The default model's parameters at M = 16 with (B, M) leaves: B
    copies with b and u scaled apart, so that each particle differs."""
    base = PSMCParams.from_dm(DemographicModel.default(pattern="16*1", theta=1e-2, rho=1e-2))
    scale = 1.0 + 0.05 * torch.linspace(0.0, 1.0, B, dtype=torch.float64)[:, None]
    leaves = {k: getattr(base, k).expand(B, -1) * (scale if k in ("b", "u") else 1.0)
              for k in PSMC_FIELDS}
    return base.replace(**{k: v.to(dtype).contiguous() for k, v in leaves.items()})


def _pi(dtype, seed=3) -> np.ndarray:
    return np.random.default_rng(seed).dirichlet(np.ones(M), size=(B, S)).astype(dtype)


def _jax_chunked(tpp: PSMCParams, pi: np.ndarray) -> JPSMCParams:
    "phlash_tpu params with (B, S, M) leaves: the particle rows per chunk, and pi."
    f = convert.psmc_fields(tpp)
    leaves = {k: jnp.broadcast_to(jnp.asarray(f[k])[:, None], (B, S, M)) for k in PARAMS6}
    return JPSMCParams(**leaves, pi=jnp.asarray(pi))


def _leaves(tpp: PSMCParams, pi: np.ndarray):
    "Port leaves that require grad: the six (B, M) rows and pi (B, S, M)."
    leaves = {k: getattr(tpp, k).clone().requires_grad_(True) for k in PARAMS6}
    return leaves, torch.tensor(pi, requires_grad=True)


def _assert_grads(got, want, atol=None, rtol=None):
    """Port gradients (b, d, u, v, emis0, emis1: (B, M); pi: (B, S, M))
    against phlash_tpu's ((B, S, M) leaves, summed over chunks but pi).
    With atol: normalized by the largest |want|; with rtol: elementwise,
    with an absolute floor of rtol * max |want|."""
    for name, a, b in zip(PSMC_FIELDS, got, want):
        b = np.asarray(b)
        if name != "pi":
            b = b.sum(1)
        scale = np.abs(b).max() + 1e-300
        if atol is not None:
            np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=atol, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=rtol * scale, err_msg=name)


def test_matches_pallas_kernel_interpret(short_data):
    """PackedKernel (plain versions, float32) against phlash_tpu's
    PallasKernel with B4 and B5 in interpret mode (seg_len 128, L = 300):
    ll rtol 1e-5 and all seven gradients normalized atol 2e-5, the gates of
    tests/test_pallas.py."""
    tpp = _batched(torch.float32)
    pi = _pi(np.float32)
    W = np.arange(1.0, B * S + 1, dtype=np.float32).reshape(B, S)
    jkern = PallasKernel(M_=M, data=short_data[:2], seg_len=128)

    def loss(p):
        ll = jkern.loglik_batched(p, jnp.array(INDS))
        return (ll * W).sum(), ll

    with pltpu.force_tpu_interpret_mode():
        (_, ll_j), g_j = jax.value_and_grad(loss, has_aux=True)(_jax_chunked(tpp, pi))

    kern = PackedKernel(M, short_data[:2], seg_len=128, device="cpu")
    leaves, tpi = _leaves(tpp, pi)
    ll = kern.loglik_batched(tpp.replace(pi=tpi, **leaves), torch.tensor(INDS))
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(ll_j), rtol=1e-5)
    g_t = torch.autograd.grad((ll * torch.as_tensor(W)).sum(), [*leaves.values(), tpi])
    _assert_grads(g_t, g_j, atol=2e-5)


@pytest.fixture(scope="module")
def dense_ref(short_data):
    """phlash_tpu's DenseKernel at float64 on rows INDS: ll (B, S) and the
    gradients of sum(W * ll), W distinct per (particle, chunk)."""
    tpp = _batched(torch.float64)
    pi = _pi(np.float64)
    W = np.arange(1.0, B * S + 1).reshape(B, S)
    jkern = JaxDenseKernel(M=M, data=short_data, double_precision=True, seg_len=64)

    def loss(p):
        ll = jkern.loglik_batched(p, jnp.array(INDS))
        return (ll * W).sum(), ll

    (_, ll), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(_jax_chunked(tpp, pi))
    return dict(tpp=tpp, pi=pi, W=W, ll=np.asarray(ll), grads=g)


@pytest.mark.parametrize("kernel", [PackedKernel, DenseKernel])
def test_loglik_matches_jax_dense(short_data, dense_ref, kernel):
    """PackedKernel (plain B4 forward, hand B5 adjoint) and the plain
    DenseKernel at float64 against phlash_tpu's DenseKernel: ll and all
    seven gradients rtol 1e-10."""
    kern = kernel(M, short_data, seg_len=128, device="cpu")
    leaves, tpi = _leaves(dense_ref["tpp"], dense_ref["pi"])
    ll = kern.loglik_batched(dense_ref["tpp"].replace(pi=tpi, **leaves), torch.tensor(INDS))
    np.testing.assert_allclose(ll.detach().numpy(), dense_ref["ll"], rtol=1e-10)
    g_t = torch.autograd.grad((ll * torch.as_tensor(dense_ref["W"])).sum(),
                              [*leaves.values(), tpi])
    _assert_grads(g_t, dense_ref["grads"], rtol=1e-10)


def test_plain_forward_and_transition_match_jax(short_data, dense_ref):
    """dense_transition against phlash_tpu's per particle (rtol 1e-14), and
    the plain B4 forward on raw rows (no kernel padding, L = 300 not a
    multiple of seg_len) against phlash_tpu's DenseKernel (rtol 1e-10)."""
    tpp, pi = dense_ref["tpp"], torch.as_tensor(dense_ref["pi"])
    A = dense_transition(tpp)
    assert A.shape == (B, M, M)
    for p in range(B):
        jpp = JPSMCParams(**{k: jnp.asarray(v[p]) for k, v in convert.psmc_fields(tpp).items()})
        np.testing.assert_allclose(A[p].numpy(), np.asarray(jax_dense_transition(jpp)),
                                   rtol=1e-14, atol=0)
    rows = torch.as_tensor(short_data[INDS])
    ll, ckpt = packed.forward_packed(A, tpp.emis0, tpp.emis1, pi, rows, seg_len=128)
    np.testing.assert_allclose(ll.numpy(), dense_ref["ll"], rtol=1e-10)
    assert ckpt.shape == (packed.n_segments(300, 128), B * S, M)
    torch.testing.assert_close(ckpt[0], pi.reshape(B * S, M), rtol=0, atol=0)


def _adjoint_case(L=45, seed=1):
    "f64 A / emissions / pi, rows with a missing block and a -2 tail, g."
    rng = np.random.default_rng(seed)
    tpp = _batched(torch.float64)
    A = dense_transition(tpp)
    pi = torch.as_tensor(rng.dirichlet(np.ones(M), size=(B, 3)))
    obs = torch.as_tensor(rng.binomial(1, 0.1, size=(3, L)).astype(np.int8))
    obs[0, 3:9] = -1
    obs[-1, L - 5:] = -2
    gbar = torch.as_tensor(rng.standard_normal((B, 3)))
    return A, tpp.emis0, tpp.emis1, pi, obs, gbar


def test_plain_adjoint_matches_autograd():
    """The hand adjoint (plain B5) equals torch.autograd through the plain
    B4 forward at float64: missing data, a -2 tail, L = 45 with segments
    of 16, nonzero g; rtol 1e-10.  The forward without checkpoints gives
    the same ll."""
    A, e0, e1, pi, obs, gbar = _adjoint_case()
    leaves = [x.clone().requires_grad_(True) for x in (A, e0, e1, pi)]
    ll, none = packed.forward_packed(*leaves, obs, seg_len=16, with_ckpt=False)
    assert none is None
    want = torch.autograd.grad((ll * gbar).sum(), leaves)
    ll2, ckpt = packed.forward_packed(A, e0, e1, pi, obs, seg_len=16)
    assert torch.equal(ll2, ll.detach()) and ckpt.shape == (3, B * 3, M)
    dA, de0, de1, dpi = packed.backward_packed(A, e0, e1, obs, ckpt, gbar, seg_len=16)
    assert dA.shape == (B, 3, M, M) and dpi.shape == (B, 3, M)
    for name, a, b in zip(("A", "emis0", "emis1", "pi"), (dA.sum(1), de0.sum(1), de1.sum(1), dpi),
                          want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10 * float(b.abs().max()), err_msg=name)


@pytest.mark.parametrize("seg_len", [packed.DEFAULT_SEG, 256])
def test_plain_adjoint_independent_of_spacing(seg_len):
    """The dense residual: the plain adjoint's gradients at float64 do not
    depend on the checkpoint spacing.  seg_len = DEFAULT_SEG (the CUDA
    kernels' period) and 256 (segments of which the last is partial) agree
    with one segment over the whole row (L = 300) to rtol 1e-12."""
    A, e0, e1, pi, obs, gbar = _adjoint_case(L=300, seed=4)
    grads = {}
    for s in (seg_len, 300):
        _, ckpt = packed.forward_packed(A, e0, e1, pi, obs, seg_len=s)
        assert ckpt.shape == (packed.n_segments(300, s), B * 3, M)
        grads[s] = packed.backward_packed(A, e0, e1, obs, ckpt, gbar, seg_len=s)
    for name, a, b in zip(("A", "emis0", "emis1", "pi"), grads[seg_len], grads[300]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()), err_msg=name)


def test_period_and_states_per_lane():
    """The kernels' mapping as csrc/packed_common.cuh states it: the
    checkpoint period is DEFAULT_SEG, each kernel's states per lane give
    groups of 4 to 16 lanes; at the fit shape (B=500, S=5) the forward runs
    315 one-warp blocks and the adjoint 315 blocks of 4 warps.  The fit's
    2000-site rows need no padding to the period."""
    import re
    from pathlib import Path

    from phlash_tpu_torch.ops import smc

    header = (Path(packed.__file__).parents[1] / "csrc" / "packed_common.cuh").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", header)}
    assert const["PACKED_PERIOD"] == packed.DEFAULT_SEG
    smc_header = (Path(packed.__file__).parents[1] / "csrc" / "smc_common.cuh").read_text()
    per_block = int(re.search(r"INSTANCES_PER_BLOCK = (\d+);", smc_header).group(1))
    geo = {}
    for name in ("PACKED_FWD_SPL", "PACKED_BWD_SPL"):
        lanes = M // const[name]
        assert M % const[name] == 0 and 4 <= lanes <= 16 and lanes & (lanes - 1) == 0
        geo[name] = smc.launch_geometry(500, 5, M, const[name], per_block)
    assert geo["PACKED_FWD_SPL"] == dict(states_per_lane=4, lanes_per_instance=4,
                                         instances_per_warp=8, threads_per_block=32,
                                         blocks=315, warps=315)
    assert geo["PACKED_BWD_SPL"] == dict(states_per_lane=1, lanes_per_instance=16,
                                         instances_per_warp=2, threads_per_block=128,
                                         blocks=315, warps=1260)
    assert PackedKernel(M, np.zeros((1, 2000), np.int8), device="cpu").data.shape == (1, 2000)


def test_packed_op_gradcheck():
    "torch.autograd.gradcheck on PackedOp (forward with checkpoints, hand adjoint)."
    A, e0, e1, pi, obs, _ = _adjoint_case(L=13, seed=2)
    leaves = [x.clone().requires_grad_(True) for x in (A, e0, e1, pi)]
    assert torch.autograd.gradcheck(lambda *xs: PackedOp.apply(obs, 4, True, *xs), leaves)


def test_padding_is_noop():
    "A row padded with -2 by hand gives the kernel's own padding's ll (tests/test_pallas.py)."
    d = np.random.default_rng(1).binomial(1, 0.05, size=(2, 200)).astype(np.int8)
    k1 = PackedKernel(M, d, seg_len=128, device="cpu")  # pads 200 -> 256
    k2 = PackedKernel(M, np.pad(d, [(0, 0), (0, 56)], constant_values=-2), seg_len=128,
                      device="cpu")
    assert k1.data.shape == k2.data.shape == (2, 256)
    tpp = _batched(torch.float32)
    pp = tpp.replace(pi=tpp.pi[:, None, :].expand(-1, 2, -1))
    with torch.no_grad():
        l1 = k1.loglik_batched(pp, torch.tensor([0, 1]))
        l2 = k2.loglik_batched(pp, torch.tensor([0, 1]))
    torch.testing.assert_close(l1, l2, rtol=1e-6, atol=0)


def test_dense_filter_matches_jax(short_data):
    """The plain DenseKernel's filter_batched against phlash_tpu's at
    float64: final states rtol 1e-10, gradients of a weighted sum of them
    w.r.t. all seven leaves rtol 1e-10."""
    tpp = _batched(torch.float64)
    warmup = short_data[:2, :150]  # holds part of the missing stretch
    T = np.linspace(0.5, 1.5, B * 2 * M).reshape(B, 2, M)
    jkern = JaxDenseKernel(M=M, data=short_data, double_precision=True, seg_len=64)
    jpps = JPSMCParams(**{k: jnp.asarray(v) for k, v in convert.psmc_fields(tpp).items()})

    def loss(p):
        out = jkern.filter_batched(p, jnp.asarray(warmup))
        return (out * T).sum(), out

    (_, want), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(jpps)
    kern = DenseKernel(M, short_data, seg_len=64, device="cpu")
    leaves = {k: getattr(tpp, k).clone().requires_grad_(True) for k in PSMC_FIELDS}
    out = kern.filter_batched(tpp.replace(**leaves), torch.as_tensor(warmup))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-10)
    g_t = torch.autograd.grad((out * torch.as_tensor(T)).sum(), list(leaves.values()))
    for name, a, b in zip(PSMC_FIELDS, g_t, g_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-10 * np.abs(b).max(),
                                   err_msg=name)


OVERLAP0_BODY, N_CHUNKS = 200, 4
AFS = np.array([30.0, 10.0, 5.0])
C = (1.0, 2.0, 1.0)


@pytest.mark.parametrize("with_afs", [False, True])
def test_log_density_packed_matches_jax(mcp, with_afs):
    """The slice's density: the port's log_density_batched through
    PackedKernel at overlap 0 against phlash_tpu's through its DenseKernel,
    float64, identical particles.  Without AFS: rtol 1e-10 (values) and
    1e-8 (gradients); with it 1e-6, since phlash_tpu evaluates the AFS term
    in float32 (tests/test_torch_model.py)."""
    from jax.flatten_util import ravel_pytree

    rng = np.random.default_rng(2)
    chunks = rng.binomial(1, 0.05, size=(N_CHUNKS, OVERLAP0_BODY)).astype(np.int8)
    chunks[1, 60:90] = -1
    inds = np.array([1, 3, 1])
    flat, unravel = ravel_pytree(mcp)
    draws = np.asarray(flat)[None] + 0.2 * rng.standard_normal((3, flat.shape[0]))
    jm = jax.vmap(unravel)(jnp.asarray(draws))
    no_prefix = np.zeros((len(inds), 0), np.int8)
    kw = dict(c=jnp.asarray(C), inds=jnp.asarray(inds), warmup=jnp.asarray(no_prefix),
              kern=JaxDenseKernel(M=M, data=chunks, double_precision=True),
              afs=jnp.asarray(AFS) if with_afs else None)

    def total(P):
        v = jax_log_density(P, **kw)
        return v.sum(), v

    (_, want), want_g = jax.jit(jax.value_and_grad(total, has_aux=True))(jm)
    want_g = np.asarray(jax.vmap(lambda m: ravel_pytree(m)[0])(want_g))

    tm = convert.from_reference_mcmc(jm)
    tkw = dict(c=C, inds=torch.as_tensor(inds), warmup=torch.as_tensor(no_prefix),
               kern=PackedKernel(M, chunks, device="cpu"),
               afs=torch.as_tensor(AFS) if with_afs else None)
    got = log_density_batched(tm, **tkw)
    got_g = batched_grad(tm)(tm.flatten(), **tkw)
    rtol_v, rtol_g = (1e-6, 1e-6) if with_afs else (1e-10, 1e-8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol_v)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=rtol_g,
                               atol=rtol_g * np.abs(want_g).max())


@pytest.fixture(scope="module")
def psmcfa(tmp_path_factory):
    "3 contigs x 3000 windows of Bernoulli(0.05) hets with a missing block."
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("psmcfa") / "small.psmcfa"
    with open(path, "w") as f:
        for k in range(3):
            seq = np.where(rng.random(3000) < 0.05, "K", "T")
            seq[1000:1100] = "N"
            f.write(f">chr{k}\n")
            for lo in range(0, 3000, 60):
                f.write("".join(seq[lo: lo + 60]) + "\n")
    return str(path)


def test_psmc_cpu_packed(psmcfa):
    """The slice on the CPU: psmc with kernel_backend="packed", overlap 0,
    8 particles, chunks of 400, 3 iterations (the held-out ELPD included)
    returns 8 finite models, through the plain packed pair only."""
    packed.reset_counts()
    models = phlash_tpu_torch.psmc([psmcfa], device="cpu", kernel_backend="packed", overlap=0,
                                   num_particles=8, chunk_size=400, niter=3)
    assert len(models) == 8
    for m in models:
        assert torch.isfinite(m.eta.t).all() and torch.isfinite(m.eta.c).all()
        assert (m.eta.c > 0).all() and np.isfinite(m.rho)
    n = packed.counts()
    assert n["forward_cuda"] == n["backward_cuda"] == 0
    assert n["backward_plain"] == 3 and n["forward_plain"] > 3  # 3 steps + the ELPD


def test_dispatch_by_device():
    "CPU tensors take the plain versions and count as such; nothing launches."
    A, e0, e1, pi, obs, gbar = _adjoint_case(L=20)
    packed.reset_counts()
    _, ckpt = packed.forward(A, e0, e1, pi, obs, 8, True)
    packed.backward(A, e0, e1, obs, ckpt, gbar, 8)
    assert packed.counts() == dict(forward_cuda=0, backward_cuda=0, forward_plain=1,
                                   backward_plain=1)


def _f32_case():
    "The adjoint case's A, emissions and pi in float32, and its rows."
    A, e0, e1, pi, obs, _ = _adjoint_case(L=20)
    return (*(x.float() for x in (A, e0, e1, pi)), obs)


# case -> (the call, the message it raises with)
REFUSALS = {
    # before any data are read or any kernel is built
    "packed_with_overlap": (lambda: phlash_tpu_torch.fit(
        [], device="cpu", kernel_backend="packed", overlap=50), "overlap=0"),
    "packed_default_overlap": (lambda: phlash_tpu_torch.fit(
        [], device="cpu", kernel_backend="packed"), "overlap=0"),
    "packed_M_not_16": (lambda: get_kernel(
        24, np.zeros((2, 16), np.int8), device="cpu", backend="packed"), "M=16"),
    # the CUDA wrapper's checks, before any launch
    "float64_on_cuda": (lambda: packed.forward_packed_cuda(*_adjoint_case(L=20)[:5]),
                        "float32"),
    "float32_cpu_to_cuda_wrapper": (lambda: packed.forward_packed_cuda(*_f32_case()),
                                    "CUDA tensors"),
    # the kernels keep a checkpoint every DEFAULT_SEG sites, checked first
    "forward_seg_len_not_the_period": (lambda: packed.forward_packed_cuda(
        *_f32_case(), seg_len=256), "seg_len=256"),
    "adjoint_seg_len_not_the_period": (lambda: packed.backward_packed_cuda(
        *_f32_case()[:3], _f32_case()[4], torch.zeros(3, 3 * B, M), torch.zeros(B, 3),
        seg_len=256), "seg_len=256"),
    "unknown_backend": (lambda: get_kernel(
        16, np.zeros((2, 16), np.int8), device="cpu", backend="pallas"), "unknown kernel backend"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals(case):
    call, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        call()


# The split path's plain rendering (packed.forward_segmented /
# backward_segmented) against the unsplit plain versions.  (B, S, L, K,
# dtype, rho, het rate, all missing): rows that forget their start within a
# few hundred sites, in float32 and float64; all-missing rows under a
# near-identity A (rho = 1e-9), where no fix chain meets and the splice
# re-runs segment after segment; and more segments asked for than the row
# has checkpoint intervals (38 periods: 3 intervals of 16).
SPLIT_CASES = {
    "mixes_f32": (3, 2, 3000, 6, torch.float32, 0.1, 0.1, False),
    "mixes_f64": (3, 2, 4000, 6, torch.float64, 0.1, 0.1, False),
    "never_meets": (3, 2, 2000, 4, torch.float64, 1e-9, 0.1, True),
    "k_past_intervals": (3, 2, 300, 50, torch.float64, 1e-2, 0.1, False),
}


def _split_case(B, S, Lr, dtype, rho, het, missing, seed=11):
    "A, emissions at theta = 0.1 and rho; random pi; rows at the het rate (or all missing), a -2 tail."
    rng = np.random.default_rng(seed)
    base = PSMCParams.from_dm(DemographicModel.default(pattern="16*1", theta=0.1, rho=rho))
    scale = 1.0 + 0.05 * torch.linspace(0.0, 1.0, B, dtype=torch.float64)[:, None]
    tpp = base.replace(**{k: getattr(base, k).expand(B, -1) * (scale if k in ("b", "u") else 1.0)
                          for k in PSMC_FIELDS})
    A, e0, e1 = (x.to(dtype).contiguous() for x in (dense_transition(tpp), tpp.emis0, tpp.emis1))
    pi = torch.as_tensor(rng.dirichlet(np.ones(M), size=(B, S))).to(dtype)
    obs = torch.as_tensor(rng.binomial(1, het, size=(S, Lr)).astype(np.int8))
    if missing:
        obs[:] = -1
    obs[-1, Lr - 5:] = -2
    gbar = torch.as_tensor(rng.standard_normal((B, S))).to(dtype)
    return A, e0, e1, pi, obs, gbar


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_plan_matches_the_unsplit_plain_versions(case):
    """The split forward's checkpoints are the unsplit forward's bit for bit,
    and so is the adjoint's dpi (abar at site 0, the carried state); ll and
    dA, de0, de1 equal the unsplit ones to rounding (float64: 1e-12 of max;
    float32: within the card's gates of the float64 unsplit values, rtol
    1e-5 and 2e-5 of max); the counts say what ran."""
    B, S, Lr, K, dtype, rho, het, missing = SPLIT_CASES[case]
    A, e0, e1, pi, obs, gbar = _split_case(B, S, Lr, dtype, rho, het, missing)
    plan = packed.segments(packed.n_segments(Lr, packed.DEFAULT_SEG), K)
    ll, ck = packed.forward_packed(A, e0, e1, pi, obs)
    ll_s, ck_s, fwd = packed.forward_segmented(A, e0, e1, pi, obs, packed.Plan(K, 0))
    assert torch.equal(ck_s, ck)
    ll_1, none, _ = packed.forward_segmented(A, e0, e1, pi, obs, packed.Plan(K, 0), False)
    assert none is None and torch.equal(ll_1, ll_s)
    *grads, dpi = packed.backward_packed(A, e0, e1, obs, ck, gbar)
    *grads_s, dpi_s, bwd = packed.backward_segmented(A, e0, e1, obs, ck, gbar, packed.Plan(K, 0))
    assert torch.equal(dpi_s, dpi)
    if dtype == torch.float64:
        want_ll, want = ll, grads
        ll_tol, grad_tol = 1e-12, 1e-12
    else:
        x64 = [x.double() for x in (A, e0, e1)]
        want_ll, ck64 = packed.forward_packed(*x64, pi.double(), obs)
        want = packed.backward_packed(*x64, obs, ck64, gbar.double())[:3]
        ll_tol, grad_tol = 1e-5, 2e-5
    np.testing.assert_allclose(ll_s.double().numpy(), want_ll.double().numpy(), rtol=ll_tol)
    for name, got, ref in zip(("A", "emis0", "emis1"), grads_s, want):
        err = float((got.double() - ref.double()).abs().max())
        assert err <= grad_tol * (float(ref.abs().max()) + 1e-300), (name, err)
    n_inst = B * S
    for c in (fwd, bwd):
        assert set(c) == set(packed.DEVICE_COUNTS)
        assert c["packed_segments"] == plan.K * n_inst and c["packed_split_sites"] == n_inst * Lr
        assert 0 <= c["packed_segments_resolved"] <= (plan.K - 1) * n_inst
    if case.startswith("mixes"):  # most fix chains meet inside their own segment
        for c in (fwd, bwd):
            assert c["packed_segments_resolved"] >= (plan.K - 1) * n_inst // 2
            assert 0 < c["packed_fix_sites"] < c["packed_split_sites"]
    elif case == "never_meets":  # no fix meets; the splice re-runs segments 2 .. K-1 whole
        seg_sites = plan.periods * packed.DEFAULT_SEG
        for c in (fwd, bwd):
            assert c["packed_segments_resolved"] == 0
        assert fwd["packed_fix_sites"] == n_inst * ((Lr - seg_sites) + (Lr - 2 * seg_sites))
    else:
        assert plan == packed.Plan(3, 16)


@pytest.mark.parametrize("direction", ["forward", "adjoint"])
def test_packed_segment_plan(direction):
    """K = 1 at the L = 2,000 shapes (the bench's and chip_smoke's B = 500,
    S = 5: B * S = 2,500 instances; the ragged 37 x 3) and wherever the
    instances already fill the card; K >= 2 along a genome's rows (the
    diploid.packed cell's 500 x 1 x 94,000 in both directions, its ELPD's
    500 x 4 forward), as many as bring the direction's launch to
    TARGET_WARPS_PER_SM an SM, in segments of whole checkpoint intervals,
    none empty and none under MIN_SEGMENT_SITES sites (but the last).  The
    states per lane it plans with are csrc/packed_common.cuh's."""
    import re
    from pathlib import Path

    from phlash_tpu_torch.ops import smc

    header = (Path(packed.__file__).parents[1] / "csrc" / "packed_common.cuh").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", header)}
    assert packed.STATES_PER_LANE == {"forward": const["PACKED_FWD_SPL"],
                                      "adjoint": const["PACKED_BWD_SPL"]}
    sms = 132
    target = packed.TARGET_WARPS_PER_SM[direction]
    for B, S, L in ((500, 5, 2000), (37, 3, 2000), (37, 3, 2501), (500, 40, 94_000),
                    (1, 1, smc.MIN_SEGMENT_SITES * 2 - 1)):
        assert packed.segment_plan(B, S, L, sms, direction).K == 1, (B, S, L)
    shapes = [(500, 1, 94_000), (500, 1, 93_999), (32, 1, 5_000), (1, 1, 10**6)]
    if direction == "forward":
        shapes.append((500, 4, 94_000))
    for B, S, L in shapes:
        n_per = packed.n_segments(L, packed.DEFAULT_SEG)
        K, P = packed.segment_plan(B, S, L, sms, direction)
        assert K >= 2 and P % smc.CHECK_PERIODS == 0 and (K - 1) * P < n_per <= K * P, (B, S, L)
        assert P * packed.DEFAULT_SEG >= smc.MIN_SEGMENT_SITES
        warps = smc.launch_geometry(B, S, M, packed.STATES_PER_LANE[direction],
                                    smc.INSTANCES_PER_BLOCK)["warps"]
        assert K * warps <= target * sms
    want = {"forward": packed.Plan(16, 736), "adjoint": packed.Plan(6, 1968)}[direction]
    assert packed.segment_plan(500, 1, 94_000, sms, direction) == want
    if direction == "forward":
        assert packed.segment_plan(500, 4, 94_000, sms, direction) == packed.Plan(4, 2944)
