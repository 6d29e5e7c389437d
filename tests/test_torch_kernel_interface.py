"""The per-particle kernel interface of phlash_tpu_torch (kernel_base.py:
`loglik`, `kern(pp, index, grad)`, `float_type`), `model.log_density` and
`hmm.psmc_ll_dm` against phlash_tpu's, float64, on the CPU.

Every port backend runs here through its plain version (`smc` and `packed`
too, device="cpu").  The JAX counterparts are built as tests/test_kernels.py
builds them: the scan backend and the hand-kernel backends against
PureXLAKernel, the dense backend against DenseKernel.  Values agree to 1e-10
relative, gradients to 1e-8 of each leaf's largest."""

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

import phlash_tpu.hmm as jhmm
from phlash_tpu.model import log_density as jax_log_density
from phlash_tpu.ops.kernel_dense import DenseKernel as JaxDenseKernel
from phlash_tpu.params import MCMCParams as JMCMCParams
from phlash_tpu.params import PSMCParams as JPSMCParams
from phlash_tpu.size_history import DemographicModel as JDemographicModel
from phlash_tpu.size_history import SizeHistory as JSizeHistory
from phlash_tpu_torch import convert, hmm
from phlash_tpu_torch.hmm import ScanKernel
from phlash_tpu_torch.kernel_base import LikelihoodKernel, one_particle
from phlash_tpu_torch.model import log_density, log_density_batched
from phlash_tpu_torch.ops import build, packed, smc
from phlash_tpu_torch.ops.kernel_dense import DenseKernel
from phlash_tpu_torch.ops.kernel_packed import PackedKernel
from phlash_tpu_torch.ops.kernel_smc import SMCKernel
from phlash_tpu_torch.params import PSMC_FIELDS, PSMCParams

M, N_CHUNKS, L, OVERLAP = 16, 6, 240, 40
INDS = [0, 2, 5]
BACKENDS = ("scan", "dense", "smc", "packed")
VALUES, GRADS = 1e-10, 1e-8


@pytest.fixture(scope="module")
def data():
    "Bernoulli(0.05) chunks of OVERLAP + L columns with a missing block."
    rng = np.random.default_rng(13)
    d = rng.binomial(1, 0.05, size=(N_CHUNKS, OVERLAP + L)).astype(np.int8)
    d[1, 90:130] = -1
    d[4, 250:] = -1
    return d


@pytest.fixture(scope="module")
def jdm():
    "A demographic model with a random time grid and rates from a numpy seed."
    rng = np.random.default_rng(5)
    t = np.concatenate([[0.0], np.geomspace(1e-3, 12.0, M - 1) * rng.uniform(0.9, 1.1, M - 1)])
    c = rng.uniform(0.3, 3.0, M)
    return JDemographicModel(eta=JSizeHistory(t=jnp.asarray(np.sort(t)), c=jnp.asarray(c)),
                             theta=1.3e-2, rho=0.9e-2)


@pytest.fixture(scope="module")
def jpp(jdm):
    return jax.jit(JPSMCParams.from_dm)(jdm)


@pytest.fixture(scope="module")
def jax_kernels(data):
    body = data[:, OVERLAP:]
    oracle = jhmm.PureXLAKernel(M=M, data=body, double_precision=True)
    dense = JaxDenseKernel(M=M, data=body, double_precision=True, seg_len=128)
    return {"scan": oracle, "dense": dense, "smc": oracle, "packed": oracle}


@pytest.fixture(scope="module")
def jax_call(jax_kernels, jpp, jdm):
    """jkern(pp, INDS, grad=True) of the backend's JAX counterpart for pp
    "psmc" or "dm", jitted and computed once per counterpart and pp (eager
    JAX costs seconds a call)."""

    @functools.lru_cache(maxsize=None)
    def call(counterpart, which):
        jkern = jax_kernels[counterpart]
        return jax.jit(lambda p: jkern(p, jnp.asarray(INDS), grad=True))(
            {"psmc": jpp, "dm": jdm}[which])

    return lambda backend, which: call("dense" if backend == "dense" else "scan", which)


def make_kernel(backend, body):
    if backend == "scan":
        return ScanKernel(M, body, device="cpu", double_precision=True)
    if backend == "dense":
        return DenseKernel(M, body, device="cpu", seg_len=128, double_precision=True)
    if backend == "smc":
        return SMCKernel(M, body, device="cpu")
    return PackedKernel(M, body, device="cpu")


@pytest.fixture(scope="module")
def kernels(data):
    return {b: make_kernel(b, data[:, OVERLAP:]) for b in BACKENDS}


def _close(got, want, rtol):
    got, want = convert.to_numpy(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _psmc_close(got: PSMCParams, want, rtol=GRADS):
    for k in PSMC_FIELDS:
        _close(getattr(got, k), getattr(want, k), rtol)


def _dm_close(got, want, rtol=GRADS):
    _close(got.eta.t, want.eta.t, rtol)
    _close(got.eta.c, want.eta.c, rtol)
    _close(got.theta, want.theta, rtol)
    _close(got.rho, want.rho, rtol)


@pytest.mark.parametrize("backend", BACKENDS)
def test_loglik_matches_jax(backend, kernels, jax_kernels, jpp, jdm):
    "loglik(pp, i) for PSMCParams and DemographicModel pp: a 0-d tensor, rtol 1e-10."
    kern, jkern = kernels[backend], jax_kernels[backend]
    pp, dm = convert.from_reference_psmc(jpp), convert.from_reference_dm(jdm)
    for i in (0, 3):
        want = float(jax.jit(jkern.loglik)(jpp, i))
        got = kern.loglik(pp, i)
        assert got.ndim == 0 and got.dtype == torch.float64
        _close(got, want, VALUES)
        _close(kern.loglik(dm, torch.tensor(i)), want, VALUES)


@pytest.mark.parametrize("backend", BACKENDS)
def test_loglik_is_differentiable(backend, kernels, jax_kernels, jpp):
    "loglik carries autograd: its gradient is jax.grad(kern.loglik)'s, 1e-8."
    kern, jkern = kernels[backend], jax_kernels[backend]
    leaves = {k: torch.tensor(np.asarray(getattr(jpp, k)), requires_grad=True)
              for k in PSMC_FIELDS}
    g = torch.autograd.grad(kern.loglik(PSMCParams(**leaves), 2), list(leaves.values()))
    want = jax.jit(jax.grad(jkern.loglik))(jpp, 2)
    _psmc_close(PSMCParams(*g), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_call_with_index_vector_matches_jax(backend, kernels, jax_call, jpp):
    """kern(pp, [0, 2, 5], grad=True) against phlash_tpu's kern(...) (its
    vmap of value_and_grad): ll (3,) to 1e-10 and per-index gradients, leaves
    (3, M), to 1e-8; the same with grad=False, and at a scalar index."""
    kern = kernels[backend]
    pp = convert.from_reference_psmc(jpp)
    want_ll, want_g = jax_call(backend, "psmc")
    ll, g = kern(pp, INDS, grad=True)
    assert ll.shape == (3,) and isinstance(g, PSMCParams) and g.b.shape == (3, M)
    _close(ll, want_ll, VALUES)
    _psmc_close(g, want_g)
    _close(kern(pp, torch.tensor(INDS), grad=False), want_ll, VALUES)

    ll0, g0 = kern(pp, 5, grad=True)
    assert ll0.ndim == 0 and g0.b.shape == (M,)
    _close(ll0, want_ll[2], VALUES)
    _psmc_close(g0, jax.tree.map(lambda a: a[2], want_g))


@pytest.mark.parametrize("backend", BACKENDS)
def test_call_with_demographic_model_matches_jax(backend, kernels, jax_call, jdm):
    """A DemographicModel pp: per-index gradients of t, c, theta and rho (each
    with a leading axis 3) through from_dm, as phlash_tpu's, 1e-8."""
    kern = kernels[backend]
    dm = convert.from_reference_dm(jdm)
    want_ll, want_g = jax_call(backend, "dm")
    ll, g = kern(dm, INDS, grad=True)
    _close(ll, want_ll, VALUES)
    assert g.eta.t.shape == (3, M) and g.theta.shape == (3,)
    _dm_close(g, want_g)
    ll0, g0 = kern(dm, 2, grad=True)
    _close(ll0, want_ll[1], VALUES)
    _dm_close(g0, jax.tree.map(lambda a: a[1], want_g))


# the chunk whose body ends in a missing run (the data's d[4, 250:])
TAIL = 4


@pytest.fixture(scope="module")
def jax_tail(jax_kernels, jdm):
    "jkern(dm, TAIL, grad=True) of the backend's JAX counterpart, jitted, once per counterpart."

    @functools.lru_cache(maxsize=None)
    def call(counterpart):
        jkern = jax_kernels[counterpart]
        return jax.jit(lambda p: jkern(p, TAIL, grad=True))(jdm)

    return lambda backend: call("dense" if backend == "dense" else "scan")


@pytest.mark.parametrize("backend", BACKENDS)
def test_model_loglik_rows_on_a_tail_chunk_matches_jax(backend, kernels, jax_tail, jdm):
    """model_loglik_rows, the fit density's entry (smc runs each row to its
    live end there), on the chunk whose body ends in a missing run: ll and
    the gradients of the model's t, c, theta and rho through from_dm against
    phlash_tpu's kern(dm, 4, grad=True), which runs the whole row; 1e-10,
    and 1e-8 of each leaf's largest."""
    from phlash_tpu_torch.size_history import DemographicModel, SizeHistory

    kern = kernels[backend]
    dm = convert.from_reference_dm(jdm)
    leaves = [torch.as_tensor(x, dtype=torch.float64).clone().requires_grad_(True)
              for x in (dm.eta.t, dm.eta.c, dm.theta, dm.rho)]
    pp = PSMCParams.from_dm(DemographicModel(eta=SizeHistory(t=leaves[0], c=leaves[1]),
                                             theta=leaves[2], rho=leaves[3]))
    rows = kern.data[[TAIL]]
    ll = kern.model_loglik_rows(one_particle(pp, 1), rows)[0, 0]
    g = torch.autograd.grad(ll, leaves)
    want_ll, want_g = jax_tail(backend)
    _close(ll, want_ll, VALUES)
    _dm_close(DemographicModel(eta=SizeHistory(t=g[0], c=g[1]), theta=g[2], rho=g[3]), want_g)
    if backend == "smc":  # the row's last periods are trimmed there
        assert int(smc.live_periods(rows)[0]) * smc.NORM_EVERY < rows.shape[1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_vector_index_equals_batched_entry(backend, kernels, jpp):
    """ROADMAP's check for the per-particle entries: each per-index loglik
    under a vector index equals loglik_batched at the same rows (one particle,
    S = 3), bitwise, and each scalar loglik to 1e-12; each per-index gradient
    equals the batched entry's gradient on that row alone, 1e-12."""
    kern = kernels[backend]
    pp = convert.from_reference_psmc(jpp)
    want = kern.loglik_batched(one_particle(pp, len(INDS)), torch.tensor(INDS))[0]
    assert torch.equal(kern(pp, INDS, grad=False), want)
    _close(torch.stack([kern.loglik(pp, i) for i in INDS]), want, 1e-12)
    _, g = kern(pp, INDS, grad=True)
    for j, i in enumerate(INDS):
        leaves = [getattr(pp, k).clone().requires_grad_(True) for k in PSMC_FIELDS]
        ll_i = kern.loglik_batched(one_particle(PSMCParams(*leaves), 1), torch.tensor([i]))
        gi = torch.autograd.grad(ll_i[0, 0], leaves)
        for k, x in zip(PSMC_FIELDS, gi):
            _close(getattr(g, k)[j], x, 1e-12)


@pytest.mark.parametrize("backend", ("smc", "packed"))
def test_index_vector_costs_one_forward_and_one_adjoint(backend, kernels, jpp, jdm):
    """A 1-d index of length 3 on a hand-kernel backend: exactly one forward
    and one adjoint call of the op layer (the plain versions' counters here;
    the CUDA launch counters on the card, chip_smoke.py phase 3d), with a
    PSMCParams and with a DemographicModel pp; grad=False one forward."""
    mod = {"smc": smc, "packed": packed}[backend]
    kern = kernels[backend]
    for pp in (convert.from_reference_psmc(jpp), convert.from_reference_dm(jdm)):
        mod.reset_counts()
        kern(pp, INDS, grad=True)
        n = mod.counts()
        assert (n["forward_plain"], n["backward_plain"]) == (1, 1), n
        mod.reset_counts()
        kern(pp, INDS, grad=False)
        n = mod.counts()
        assert (n["forward_plain"], n["backward_plain"]) == (1, 0), n


@pytest.mark.parametrize("backend", BACKENDS)
def test_float_type(backend, kernels):
    """The dtype each kernel computes in: the hand-kernel backends'
    build.KERNEL_DTYPE entry for their device (none on the CPU: the
    parameters' dtype), float64 for dense / scan with double_precision and
    the parameters' (None) without."""
    kern = kernels[backend]
    assert isinstance(kern, LikelihoodKernel)
    if backend in ("smc", "packed"):
        assert kern.float_type is build.KERNEL_DTYPE.get("cpu")
        assert build.KERNEL_DTYPE["cuda"] == torch.float32
    else:
        assert kern.float_type == torch.float64
        assert make_kernel(backend, np.zeros((1, 8), np.int8)).float_type == torch.float64
        plain = (ScanKernel(M, np.zeros((1, 8), np.int8), device="cpu") if backend == "scan"
                 else DenseKernel(M, np.zeros((1, 8), np.int8), device="cpu"))
        assert plain.float_type is None


@pytest.mark.parametrize("backend", ("smc", "packed"))
def test_float32_kernel_dtype_casts_back(backend, kernels, jpp, monkeypatch):
    """With a float32 kernel dtype (as on CUDA; rehearsed by setting the "cpu"
    entry), float64 pp gets float64 values and gradients back, within float32
    rounding of the float64 ones."""
    kern = kernels[backend]
    pp = convert.from_reference_psmc(jpp)
    want_ll, want_g = kern(pp, INDS, grad=True)
    monkeypatch.setitem(build.KERNEL_DTYPE, "cpu", torch.float32)
    assert kern.float_type == torch.float32
    ll, g = kern(pp, INDS, grad=True)
    assert ll.dtype == torch.float64 and g.b.dtype == torch.float64
    _close(ll, want_ll, 1e-5)
    for k in PSMC_FIELDS:
        _close(getattr(g, k), getattr(want_g, k), 2e-4)


def test_index_must_be_0d_or_1d(kernels, jpp):
    with pytest.raises(ValueError, match="0-d or 1-d"):
        kernels["scan"](convert.from_reference_psmc(jpp), [[0, 1]], grad=False)


@pytest.mark.parametrize("cls", (SMCKernel, PackedKernel, DenseKernel, ScanKernel))
def test_kernel_classes_default_to_cuda(cls):
    """The kernel classes run on the card unless asked for the CPU: with no
    CUDA device a default construction raises, and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default construction succeeds")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(M, np.zeros((2, 16), np.int8))
    assert cls(M, np.zeros((2, 16), np.int8), device="cpu").data.device.type == "cpu"


def test_psmc_ll_dm_matches_jax(jdm, data):
    "hmm.psmc_ll_dm: the final filtered state and ll of one row, rtol 1e-10."
    row = data[3]
    want_alpha, want_ll = jhmm.psmc_ll_dm(jdm, jnp.asarray(row))
    alpha, ll = hmm.psmc_ll_dm(convert.from_reference_dm(jdm), torch.as_tensor(row))
    _close(ll, want_ll, VALUES)
    _close(alpha, want_alpha, VALUES)


def _jax_particle(seed):
    "One MCMCParams near the fit's default init, from a numpy seed."
    base = JMCMCParams.from_linear(pattern="14*1+1*2", t1=1e-4, tM=15.0, c=np.ones(15),
                                   theta=1e-2, rho=1e-2, alpha=0.0, beta=0.0)
    flat, unravel = jax.flatten_util.ravel_pytree(base)
    rng = np.random.default_rng(seed)
    return unravel(jnp.asarray(np.asarray(flat) + 0.2 * rng.standard_normal(flat.shape[0])))


@functools.lru_cache(maxsize=None)
def _jax_log_density(overlap: int, with_afs: bool, data_bytes: bytes):
    "phlash_tpu.model.log_density's value and gradient, jitted, once per case."
    data = np.frombuffer(data_bytes, np.int8).reshape(N_CHUNKS, OVERLAP + L)
    inds = np.array(DENSITY_INDS)
    kw = dict(c=jnp.asarray(DENSITY_C), inds=jnp.asarray(inds),
              warmup=jnp.asarray(data[inds, OVERLAP - overlap:OVERLAP]),
              kern=JaxDenseKernel(M=16, data=data[:, OVERLAP:], double_precision=True),
              afs=jnp.asarray(AFS) if with_afs else None)
    return jax.jit(jax.value_and_grad(lambda m: jax_log_density(m, **kw)))(_jax_particle(7))


DENSITY_INDS, DENSITY_C, AFS = (1, 4, 1), (1.0, 2.0, 1.0), (30.0, 10.0, 5.0)


@pytest.mark.parametrize("backend", ("dense", "smc"))
@pytest.mark.parametrize("overlap", [OVERLAP, 0])
@pytest.mark.parametrize("with_afs", [False, True])
def test_log_density_matches_jax(backend, overlap, with_afs, data):
    """model.log_density (one particle) against phlash_tpu.model.log_density
    with phlash_tpu's dense kernel, with a warm-up prefix and the zero-width
    warm-up (pi passes through): values 1e-10 without the AFS term and 1e-6
    with it (phlash_tpu evaluates the AFS term in float32 in a float64
    graph; ROADMAP §C), gradients 1e-8 of the largest (1e-6 with it).  On the
    same rows it equals log_density_batched's row."""
    import dataclasses

    want, want_g = _jax_log_density(overlap, with_afs, data.tobytes())
    inds = np.array(DENSITY_INDS)
    warm = data[inds, OVERLAP - overlap:OVERLAP]
    body = data[:, OVERLAP:]
    afs = np.array(AFS) if with_afs else None
    c = DENSITY_C
    tm = convert.from_reference_mcmc(_jax_particle(7))
    leaves = [tm.t_tr.clone().requires_grad_(True), tm.c_tr.clone().requires_grad_(True),
              tm.rho_over_theta_tr.clone().requires_grad_(True)]
    tm = dataclasses.replace(tm, t_tr=leaves[0], c_tr=leaves[1], rho_over_theta_tr=leaves[2])
    tkw = dict(c=c, inds=torch.as_tensor(inds), warmup=torch.as_tensor(warm),
               kern=make_kernel(backend, body), afs=None if afs is None else torch.as_tensor(afs))
    got = log_density(tm, **tkw)
    assert got.ndim == 0
    rtol_v, rtol_g = (1e-6, 1e-6) if with_afs else (VALUES, GRADS)
    _close(got, float(want), rtol_v)
    got_g = torch.autograd.grad(got, leaves)
    for g, k in zip(got_g, ("t_tr", "c_tr", "rho_over_theta_tr")):
        _close(g, getattr(want_g, k), rtol_g)

    batched = dataclasses.replace(tm, t_tr=tm.t_tr[None], c_tr=tm.c_tr[None],
                                  rho_over_theta_tr=tm.rho_over_theta_tr[None])
    assert torch.equal(got, log_density_batched(batched, **tkw)[0])
