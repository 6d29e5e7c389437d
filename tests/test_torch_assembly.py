"""The step's assembly (ops/assembly.py) on the CPU: particle coordinates ->
the seven PSMCParams leaves, the log prior and the AFS term, and the
gradient of their dot with cotangents.

- The plain version against phlash_tpu (float64): leaves and prior rtol
  1e-10 (pi, whose entries cancel, against max pi); the AFS term 1e-10 against phlash_tpu's etbl in float64 and 1e-6
  against phlash_tpu.model's term, which that package evaluates in float32
  (ROADMAP section C); gradients against jax.grad 1e-8 of max|JAX| (not at
  c_tr = 0, where the packages' softplus derivatives differ).
- torch's forward-mode tangents of the plain version (torch.func.jvp, one
  coordinate at a time) against its reverse mode, float64, 1e-10 of
  max|reverse| per particle: the hand kernel A2 runs A1's code on dual
  numbers, so this is what holds that strategy to torch's branch and clamp
  semantics.  Each case includes particles that reach every branch that
  the assembly takes on its values (asserted by `_branches`).
- The kernels' own arithmetic (csrc/assembly_common.cuh) compiled by the
  host's C++ compiler, against the plain version: float64 values rtol
  1e-10 and
  gradients 1e-10 of max|plain|; float32 no worse than twice the plain
  float32 version's own error against float64 (or 4 float32 ulps), and within
  test_torch_params' 1e-4 relative / 1e-6 absolute (pi).
- AssemblyOp on the CPU equals the path it replaced bitwise, values and
  gradients, and its plain counters count exactly.
- chip_smoke.py phase 3c's one-ulp spread (`ulp_spread`, one stacked call)
  against its definition, one coordinate and direction a call, its gate's
  reading (`ulp_ratio`) and resolution (`ulp_resolution`), and the gate
  rehearsed on the host-compiled A2.
- The CUDA wrappers refuse CPU tensors; the on-card check skips here.
Inputs come from numpy seeds and hypothesis, at P = 7 to 37.
"""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.scipy.special import xlogy as jax_xlogy  # noqa: E402

from phlash_tpu.model import log_density_batched as jax_log_density  # noqa: E402
from phlash_tpu.model import log_prior as jax_log_prior  # noqa: E402
from phlash_tpu.ops.kernel_dense import DenseKernel  # noqa: E402
from phlash_tpu.params import MCMCParams as JMCMCParams  # noqa: E402
from phlash_tpu.params import PSMCParams as JPSMCParams  # noqa: E402
from phlash_tpu_torch import convert  # noqa: E402
from phlash_tpu_torch.afs import default_afs_transform  # noqa: E402
from phlash_tpu_torch.model import log_afs, log_density_batched, log_prior  # noqa: E402
from phlash_tpu_torch.ops import assembly  # noqa: E402
from phlash_tpu_torch.ops.build import CSRC  # noqa: E402
from phlash_tpu_torch.ops.kernel_smc import SMCKernel  # noqa: E402
from phlash_tpu_torch.params import PSMC_FIELDS, MCMCParams, PSMCParams, _expand_index  # noqa: E402
from phlash_tpu_torch.size_history import _W_tensor  # noqa: E402
from phlash_tpu_torch.utils import Pattern  # noqa: E402

PATTERNS = ("8*1", "14*1+1*2", "32*1")
N_EDGE = 6  # the edge particles _cloud puts first
SOFTPLUS_AT_0 = 2  # the edge particle whose c_tr are 0
EPS32 = float(np.finfo(np.float32).eps)


def _init(pattern: str, dtype=torch.float64) -> MCMCParams:
    K = len(Pattern(pattern))
    return MCMCParams.from_linear(pattern, t1=1e-4, tM=15.0, c=np.ones(K), theta=1e-2,
                                  rho=1e-2, alpha=0.3, beta=0.01, dtype=dtype)


def _cloud(pattern: str, P: int, seed: int, scale: float = 0.5) -> torch.Tensor:
    """(P, D) float64 coordinates around the default model; the first
    N_EDGE particles sit where the assembly's branches and clamps switch."""
    init = _init(pattern)
    K = len(Pattern(pattern))
    x0 = init.flatten().numpy()
    x = x0 + scale * np.random.default_rng(seed).standard_normal((P, x0.shape[0]))
    x[0, 0] = math.log(2e-7)  # short first sub-intervals: _expQ2's tiny branch
    x[1, 0] = math.log(1e-9)  # sub-intervals under 1e-8: the degenerate override
    x[SOFTPLUS_AT_0, 2:2 + K] = 0.0  # softplus at 0 (torch's abs' has sign(0) = 0)
    x[3, 1], x[3, 2:2 + K] = math.log(60.0), 5.0  # expm1inv's x > 10; p_surv and A clamps
    x[4, 2:2 + K], x[4, -1] = -5.0, 6.0  # rho > c: _expQ2's w > 0 swap
    x[5, 2:2 + K] = np.linspace(-6.0, 5.0, K)  # a wide spread of rates, none 0
    return torch.as_tensor(x)


def _afs_case(n_minus_1: int, transform: bool, seed: int = 3):
    "(afs, afs_transform) in float64, with zero counts; (None, None) for n - 1 = 0."
    if n_minus_1 == 0:
        return None, None
    afs = np.random.default_rng(seed).integers(1, 60, n_minus_1).astype(float)
    afs[1] = 0.0  # xlogy at a zero count
    T = torch.as_tensor(default_afs_transform(afs)) if transform else None
    return torch.as_tensor(afs), T


def _branches(init: MCMCParams, x: torch.Tensor) -> dict:
    """Which of the assembly's value-dependent branches the particles reach,
    recomputed from transition_matrix's and texp_mean's own predicates."""
    from phlash_tpu_torch.transition import transition_matrix

    dm = init.unflatten(x).to_dm()
    c, t = dm.eta.c, dm.eta.t
    dt = torch.diff(t)
    xm = c[:, :-1] * dt
    g = torch.where(xm.abs() < 0.1, 0.5 - xm / 12, 1 / xm - 1 / torch.expm1(xm))
    d_te = torch.cat([dt * g, 1 / c[:, -1:]], -1)
    d_et = dt * (1 - g)
    dgrid = torch.cat([torch.stack([d_te[:, :-1], d_et], -1).flatten(-2), d_te[:, -1:]], -1)
    degenerate = torch.isclose(dgrid, torch.zeros_like(dgrid))
    cc = dgrid * torch.repeat_interleave(c, 2, -1)[:, :-1]
    r = 2 * dgrid * dm.rho[:, None]
    u = torch.sqrt((2 * cc) ** 2 + r**2) / 2
    v, w = (r + 2 * cc) / 2, (r - 2 * cc) / 2
    a, b = -cc * r / (u + v), -(u + v)
    series = torch.maximum(a.abs(), b.abs()) < 0.05
    live = ~degenerate
    A = transition_matrix(dm)
    c_tr = init.unflatten(x).c_tr
    return {
        "texp_mean taylor": bool((xm.abs() < 0.1).any()),
        "texp_mean generic": bool((xm.abs() >= 0.1).any()),
        "expm1inv x > 10": bool((xm > 10).any()),
        "degenerate sub-interval": bool(degenerate.any()),
        "_expQ2 tiny": bool(((u < 1e-6) & live).any()),
        "_expQ2 generic": bool(((u >= 1e-6) & live).any()),
        "p02 series": bool((series & live).any()),
        "p02 generic": bool((~series & live).any()),
        "w <= 0": bool(((w <= 0) & live).any()),
        "w > 0": bool(((w > 0) & live).any()),
        "p_surv clamp": bool((torch.exp(-xm) < 1e-8).any()),
        "A clip 1e-20": bool((A[:, 0, 1:] < 1e-20).any()),
        "softplus at 0": bool((c_tr == 0).any()),
    }


def _assert_leaves_close(got, want, rtol: float) -> None:
    """(P, 7, M) leaves entrywise within rtol, but pi against max pi: its
    entries are differences of survivals near 1 and its first is 1 minus
    their sum, which cancel (down to ~1e-9 at the edge particles) and keep
    only an absolute accuracy."""
    for f, name in enumerate(PSMC_FIELDS):
        if name == "pi":
            assert _normalized(got[:, f], want[:, f]) <= rtol, name
        else:
            np.testing.assert_allclose(got[:, f], want[:, f], rtol=rtol, atol=0, err_msg=name)


def _rel(a, b) -> float:
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def _normalized(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


# ---------------------------------------------------------------------------
# the plain version against phlash_tpu
# ---------------------------------------------------------------------------


def _jax_parts(jm, afs, T):
    "phlash_tpu's leaves (P, 7, M), log prior and float64 AFS term of particles jm."
    def one(m):
        dm = m.to_dm()
        pp = JPSMCParams.from_dm(dm)
        etbl = dm.eta.etbl(afs.shape[0] + 1)
        esfs = etbl / etbl.sum()
        l_afs = jax_xlogy(T @ afs, (T * esfs).sum(-1)).sum()
        return jnp.stack([getattr(pp, k) for k in PSMC_FIELDS]), jax_log_prior(m), l_afs

    return jax.vmap(one)(jm)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_plain_matches_jax_f64(pattern):
    """assemble_plain against phlash_tpu's from_dm / log_prior / AFS term on
    the same float64 coordinates (the edge particles included), and (at the
    fit's pattern) the AFS term against phlash_tpu.model's float32
    evaluation at 1e-6."""
    P = {"8*1": 7, "14*1+1*2": 23, "32*1": 37}[pattern]
    x = _cloud(pattern, P, seed=11)
    init = _init(pattern)
    afs, T = _afs_case(9, transform=True)
    leaves, l_prior, l_afs = assembly.assemble_plain(init, x, afs, T)
    jm = JMCMCParams(**convert.mcmc_fields(init.unflatten(x)))
    want = jax.jit(_jax_parts)(jm, jnp.asarray(afs.numpy()), jnp.asarray(T.numpy()))
    _assert_leaves_close(leaves, torch.as_tensor(np.asarray(want[0])), rtol=1e-10)
    for got, w, what in zip((l_prior, l_afs), want[1:], ("prior", "AFS term")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-10, atol=0, err_msg=what)
    if pattern != "14*1+1*2":
        return
    # phlash_tpu.model's AFS term (float32 inside its float64 graph): c = (0, 0, 1)
    kern = DenseKernel(M=init.M, data=np.zeros((1, 8), np.int8), double_precision=True)
    jl = jax.jit(lambda m: jax_log_density(
        m, jnp.array([0.0, 0.0, 1.0]), jnp.array([0]), jnp.zeros((1, 0), jnp.int8), kern,
        jnp.asarray(afs.numpy()), jnp.asarray(T.numpy())))(jm)
    np.testing.assert_allclose(l_afs.numpy(), np.asarray(jl), rtol=1e-6, atol=0)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_vjp_plain_matches_jax_grad(pattern):
    "assemble_vjp_plain against jax.grad of the same weighted sum: 1e-8 of max|JAX|."
    # without the softplus-at-0 particle: there torch's softplus has
    # derivative 1 (clamp_min passes the gradient at 0, abs' = sign(0) = 0)
    # and phlash_tpu's 0, a divergence of the two packages, not of the kernels
    x = _cloud(pattern, {"8*1": 10, "14*1+1*2": 18, "32*1": 8}[pattern], seed=12)
    x = torch.cat([x[:SOFTPLUS_AT_0], x[SOFTPLUS_AT_0 + 1:]])
    P = len(x)
    init = _init(pattern)
    afs, T = _afs_case(15, transform=False)
    rng = np.random.default_rng(13)
    g = [rng.standard_normal(s) for s in ((P, 7, init.M), (P,), (P,))]
    got = assembly.assemble_vjp_plain(init, x, afs, None, *map(torch.as_tensor, g))
    jm = JMCMCParams(**convert.mcmc_fields(init.unflatten(x)))
    eye = jnp.eye(15)

    def loss(m):
        parts = _jax_parts(m, jnp.asarray(afs.numpy()), eye)
        return sum((p * jnp.asarray(w)).sum() for p, w in zip(parts, g))

    gj = jax.jit(jax.grad(loss))(jm)
    want = np.asarray(jax.vmap(lambda m: jax.flatten_util.ravel_pytree(m)[0])(gj))
    assert np.abs(got.numpy() - want).max() <= 1e-8 * np.abs(want).max()


# ---------------------------------------------------------------------------
# torch's forward mode against its reverse mode (the dual-number strategy)
# ---------------------------------------------------------------------------


def _forward_mode_error(pattern: str, x: torch.Tensor, afs, T, seed: int) -> float:
    """Largest |forward - reverse| / max|reverse| over particles of the
    gradient of <g, assemble_plain(x)>: forward by torch.func.jvp along each
    coordinate, reverse by assemble_vjp_plain."""
    init = _init(pattern)
    f = lambda xx: assembly._assemble(init, xx, afs, T)  # noqa: E731
    rng = np.random.default_rng(seed)
    g = [torch.as_tensor(rng.standard_normal(o.shape)) for o in f(x)]
    rev = assembly.assemble_vjp_plain(init, x, afs, T, *g)
    fwd = torch.zeros_like(rev)
    for d in range(x.shape[1]):
        e = torch.zeros_like(x)
        e[:, d] = 1.0
        _, tangents = torch.func.jvp(f, (x,), (e,))
        fwd[:, d] = sum((gi * ti).reshape(len(x), -1).sum(1) for gi, ti in zip(g, tangents))
    return float(((fwd - rev).abs().max(1).values / rev.abs().max(1).values).max())


@pytest.mark.parametrize("pattern", PATTERNS)
def test_forward_mode_matches_reverse_mode_at_the_edges(pattern):
    """Edge particles that reach every value-dependent branch of the
    assembly (asserted), with an AFS term and a zero count: 1e-10."""
    x = _cloud(pattern, N_EDGE + 3, seed=14)
    reached = _branches(_init(pattern), x)
    assert all(reached.values()), {k: v for k, v in reached.items() if not v}
    afs, T = _afs_case(8, transform=True)
    assert _forward_mode_error(pattern, x, afs, T, seed=15) <= 1e-10


@settings(max_examples=4, deadline=None, derandomize=True, database=None)
@given(pattern=st.sampled_from(PATTERNS), P=st.integers(7, 37), seed=st.integers(0, 2**16),
       scale=st.floats(0.1, 1.5), n_minus_1=st.sampled_from((0, 8, 15)))
def test_forward_mode_matches_reverse_mode(pattern, P, seed, scale, n_minus_1):
    "Random clouds around the default model: 1e-10."
    x = _cloud(pattern, N_EDGE + P, seed, scale)[N_EDGE:]
    afs, T = _afs_case(n_minus_1, transform=seed % 2 == 0, seed=seed)
    assert _forward_mode_error(pattern, x, afs, T, seed) <= 1e-10


# ---------------------------------------------------------------------------
# the kernels' arithmetic, compiled for the host
# ---------------------------------------------------------------------------

HOST_SHIM = r"""
#include <vector>
#include "assembly_common.cuh"
using namespace phlash_assembly;
template <class T> struct Store {
  T* leaves; T* lp; T* la; int M;
  void leaf(int f, int j, T v) { leaves[f * M + j] = v; }
  void prior(T v) { *lp = v; }
  void afs(T v) { *la = v; }
};
template <class T> struct Contract {
  const T* g; T gp, ga, acc; int M;
  void leaf(int f, int j, Dual<T> v) { acc += g[f * M + j] * v.d; }
  void prior(Dual<T> v) { acc += gp * v.d; }
  void afs(Dual<T> v) { acc += ga * v.d; }
};
template <class T>
Inputs<T> make(const void* x, const long long* e, const void* afs, const void* tr,
               const void* w, int P, int D, int M, int nm1, int R, double th, double al,
               double be) {
  return Inputs<T>{(const T*)x, e, (const T*)afs, (const T*)tr, (const T*)w, P, D, M, nm1, R,
                   (T)th, (T)al, (T)be};
}
template <class T>
void fwd(Inputs<T> in, T* leaves, T* lp, T* la) {
  std::vector<T> scr((2 * in.M + in.nm1) * in.P);
  for (int p = 0; p < in.P; ++p) {
    Store<T> o{leaves + (size_t)p * 7 * in.M, lp + p, la + p, in.M};
    assemble<T, T>(in, p, -1, scr.data() + p, in.P, o);
  }
}
template <class T>
void bwd(Inputs<T> in, const T* g, const T* gp, const T* ga, T* grad) {
  const int n = in.P * in.D;
  std::vector<Dual<T>> scr((2 * in.M + in.nm1) * (size_t)n);
  for (int i = 0; i < n; ++i) {
    const int p = i / in.D;
    Contract<T> c{g + (size_t)p * 7 * in.M, gp[p], ga[p], T(0), in.M};
    assemble<Dual<T>, T>(in, p, i % in.D, scr.data() + i, n, c);
    grad[i] = c.acc;
  }
}
#define ARGS const void *x, const long long *e, const void *afs, const void *tr, \
  const void *w, int P, int D, int M, int nm1, int R, double th, double al, double be
#define PASS x, e, afs, tr, w, P, D, M, nm1, R, th, al, be
extern "C" {
void fwd4(ARGS, void* l, void* lp, void* la) {
  fwd<float>(make<float>(PASS), (float*)l, (float*)lp, (float*)la); }
void fwd8(ARGS, void* l, void* lp, void* la) {
  fwd<double>(make<double>(PASS), (double*)l, (double*)lp, (double*)la); }
void bwd4(ARGS, const void* g, const void* gp, const void* ga, void* gr) {
  bwd<float>(make<float>(PASS), (const float*)g, (const float*)gp, (const float*)ga,
             (float*)gr); }
void bwd8(ARGS, const void* g, const void* gp, const void* ga, void* gr) {
  bwd<double>(make<double>(PASS), (const double*)g, (const double*)gp, (const double*)ga,
              (double*)gr); }
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    "csrc/assembly_common.cuh built by the host's C++ compiler into a ctypes library."
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/assembly_common.cuh with")
    d = tmp_path_factory.mktemp("assembly_host")
    src, lib = d / "shim.cpp", d / "libassembly_host.so"
    src.write_text(HOST_SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}", str(src),
                    "-o", str(lib)], check=True, capture_output=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    P_, I_, D_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name, extra in (("fwd4", 3), ("fwd8", 3), ("bwd4", 4), ("bwd8", 4)):
        getattr(so, name).argtypes = [P_] * 5 + [I_] * 5 + [D_] * 3 + [P_] * extra
    return so


def _host(so, init, x, afs, T, g=None):
    "The device function on the host: A1's outputs, or A2's gradient given cotangents g."
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    M, D = assembly._widths(init.pattern)
    P, dt = x.shape[0], x.dtype
    nm1 = 0 if afs is None else afs.shape[0]
    R = 0 if afs is None else (nm1 if T is None else T.shape[0])
    W = None if afs is None else _W_tensor(nm1 + 1, dt, torch.device("cpu"))
    e = _expand_index(init.pattern, torch.device("cpu"))
    args = (ptr(x), ptr(e), ptr(afs), ptr(T), ptr(W), P, D, M, nm1, R, init.theta, init.alpha,
            init.beta)
    k = x.element_size()
    if g is None:
        out = (torch.empty(P, 7, M, dtype=dt), torch.empty(P, dtype=dt), torch.empty(P, dtype=dt))
        getattr(so, f"fwd{k}")(*args, *map(ptr, out))
        return out
    grad = torch.empty(P, D, dtype=dt)
    getattr(so, f"bwd{k}")(*args, *map(ptr, g), ptr(grad))
    return grad


def _f32_error(a, b, field: int) -> float:
    "test_torch_params' measure: pi absolute, every other leaf relative above 1e-12."
    a, b = a.double(), b.double()
    if field == PSMC_FIELDS.index("pi"):
        return float((a - b).abs().max())
    m = b.abs() > 1e-12
    return float(((a - b).abs() / b.abs())[m].max())


@pytest.mark.parametrize("n_minus_1", [0, 8, 15])
@pytest.mark.parametrize("pattern", ["8*1", "14*1+1*2", "32*1", "64*1"])
def test_device_function_on_the_host(host_kernels, pattern, n_minus_1):
    """A1's and A2's device code (host-compiled) against the plain version:
    float64 and float32, edge particles included."""
    P = 7 if pattern == "64*1" else 19
    x64 = _cloud(pattern, P, seed=21 + n_minus_1).contiguous()
    afs, T = _afs_case(n_minus_1, transform=n_minus_1 == 8)
    init = _init(pattern)
    rng = np.random.default_rng(22)
    g64 = [torch.as_tensor(rng.standard_normal(s)) for s in ((P, 7, init.M), (P,), (P,))]
    want = assembly.assemble_plain(init, x64, afs, T)
    want_g = assembly.assemble_vjp_plain(init, x64, afs, T, *g64)

    got = _host(host_kernels, init, x64, afs, T)
    _assert_leaves_close(got[0], want[0], rtol=1e-10)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0)
    assert _normalized(_host(host_kernels, init, x64, afs, T, g64), want_g) <= 1e-10

    # float32: the kernel's error against float64 within 2x the plain
    # version's, or within 4 float32 ulps where the plain one happens to be
    # rounded better (one scalar a particle: the prior, the AFS term)
    init32, x32 = init.to(dtype=torch.float32), x64.float().contiguous()
    a32, T32 = (None, None) if afs is None else (afs.float(), None if T is None else T.float())
    g32 = [t.float().contiguous() for t in g64]
    got = _host(host_kernels, init32, x32, a32, T32)
    plain = assembly.assemble_plain(init32, x32, a32, T32)
    pi = PSMC_FIELDS.index("pi")
    for f in range(7):
        k_err = _f32_error(got[0][:, f], want[0][:, f], f)
        p_err = _f32_error(plain[0][:, f], want[0][:, f], f)
        assert k_err <= max(2 * p_err, 4 * EPS32), (PSMC_FIELDS[f], k_err, p_err)
        assert k_err <= (1e-6 if f == pi else 1e-4), (PSMC_FIELDS[f], k_err)
    terms = zip(("prior", "AFS term"), got[1:], plain[1:], want[1:])
    for what, a, p, w in list(terms)[: 2 if n_minus_1 else 1]:
        assert _rel(a, w) <= max(2 * _rel(p, w), 4 * EPS32), (what, _rel(a, w), _rel(p, w))
    k_g = _normalized(_host(host_kernels, init32, x32, a32, T32, g32), want_g)
    p_g = _normalized(assembly.assemble_vjp_plain(init32, x32, a32, T32, *g32), want_g)
    assert k_g <= max(2 * p_g, 4 * EPS32), (k_g, p_g)


@pytest.mark.parametrize("n_minus_1", [0, 8, 15])
@pytest.mark.parametrize("pattern", ["8*1", "14*1+1*2", "32*1", "64*1"])
def test_device_function_within_the_ulp_gate_on_the_host(host_kernels, pattern, n_minus_1):
    """chip_smoke.py phase 3c's one-ulp gate rehearsed on the host: A2's
    device code (host-compiled) in float32 within ULP_GATE one-ulp spreads
    of the plain float32 gradient, the edge particles and the rest each on
    their own (the readings print under pytest -s)."""
    import chip_smoke

    P = 7 if pattern == "64*1" else 19
    x64 = _cloud(pattern, P, seed=21 + n_minus_1).contiguous()
    afs, T = _afs_case(n_minus_1, transform=n_minus_1 == 8)
    init32 = _init(pattern).to(dtype=torch.float32)
    rng = np.random.default_rng(22)
    g32 = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32).contiguous()
           for s in ((P, 7, init32.M), (P,), (P,))]
    x32 = x64.float().contiguous()
    a32, T32 = (None, None) if afs is None else (afs.float(), None if T is None else T.float())
    got = _host(host_kernels, init32, x32, a32, T32, g32)
    plain, spread = chip_smoke.ulp_spread(torch, init32, x32, a32, T32, g32)
    for part, sl in (("edge", slice(0, N_EDGE)), ("rest", slice(N_EDGE, None))):
        ratio = chip_smoke.ulp_ratio(torch, got[sl], plain[sl], spread[sl])
        print(f"{pattern} n-1={n_minus_1} {part}: {ratio:.2f} one-ulp spreads")
        assert ratio <= chip_smoke.ULP_GATE, (part, ratio)


# ---------------------------------------------------------------------------
# AssemblyOp in the density, on the CPU
# ---------------------------------------------------------------------------


def _density_before(mcps, c, warmup, rows, kern, afs, afs_transform):
    "model.log_density_batched as it was before AssemblyOp (the assembly as tensor code)."
    dms = mcps.to_dm()
    pp = PSMCParams.from_dm(dms)
    pis = kern.filter_batched(pp, warmup)
    l_hmm = kern.loglik_rows(pp.replace(pi=pis), rows).sum(1)
    l_prior = log_prior(mcps)
    l_afs = (log_afs(dms.eta, afs, afs_transform) if afs is not None
             else torch.zeros_like(l_prior))
    total = c[0] * l_prior + c[1] * l_hmm + c[2] * l_afs
    return torch.where(torch.isfinite(total), total, torch.full_like(total, -math.inf))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("afs_kind", ["none", "afs", "afs and transform"])
def test_assembly_op_is_the_old_path_bitwise(dtype, afs_kind):
    """log_density_batched (through AssemblyOp) against the tensor code it
    replaced: values and gradients bitwise; one plain forward and one plain
    backward counted, and no launch."""
    pattern = "14*1+1*2"
    x = _cloud(pattern, 11, seed=31).to(dtype)
    init = _init(pattern, dtype)
    data = np.random.default_rng(32).binomial(1, 0.05, size=(3, 120)).astype(np.int8)
    kern = SMCKernel(init.M, data[:, 40:])
    warm, inds = torch.as_tensor(data[:, :40]), torch.arange(3)
    afs, T = _afs_case(0 if afs_kind == "none" else 5, transform=afs_kind != "afs")
    afs, T = (None if a is None else a.to(dtype) for a in (afs, T))
    c = (1.0, 2.0, 1.0)
    x_old, x_new = (x.clone().requires_grad_(True) for _ in range(2))
    want = _density_before(init.unflatten(x_old), c, warm, kern.data[inds], kern, afs, T)
    assembly.reset_counts()
    got = log_density_batched(init.unflatten(x_new), c, inds, warm, kern, afs, T)
    g_want = torch.autograd.grad(want.sum(), x_old)[0]
    g_got = torch.autograd.grad(got.sum(), x_new)[0]
    assert torch.equal(got, want) and torch.equal(g_got, g_want)
    assert assembly.counts() == dict(forward_cuda=0, backward_cuda=0, forward_plain=1,
                                     backward_plain=1)
    with torch.no_grad():  # the held-out ELPD: the forward only
        log_density_batched(init.unflatten(x), c, inds, warm, kern, afs, T)
    assert assembly.counts()["forward_plain"] == 2 and assembly.counts()["backward_plain"] == 1


def test_cuda_wrappers_refuse_cpu_tensors():
    "The kernels' wrappers take CUDA tensors only: a CPU tensor raises before any launch."
    init = _init("8*1")
    x = _cloud("8*1", 7, seed=41).contiguous()
    g = (torch.zeros(7, 7, 8, dtype=x.dtype), torch.zeros(7, dtype=x.dtype),
         torch.zeros(7, dtype=x.dtype))
    assembly.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        assembly.forward_cuda(init, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        assembly.backward_cuda(init, x, None, None, *g)
    with pytest.raises(ValueError, match="no assembly"):
        assembly.forward(init, x.to("meta"), None, None)
    assert assembly.counts() == dict(forward_cuda=0, backward_cuda=0, forward_plain=0,
                                     backward_plain=0)


@pytest.mark.parametrize("pattern, nm1", [("8*1", 0), ("14*1+1*2", 3)])
def test_phase_3c_ulp_spread_is_its_definition(pattern, nm1):
    """ulp_spread's float32 plain gradient is the plain version's, and its
    spread is, for each particle and gradient coordinate, the largest change
    of that gradient when one input coordinate moves one ulp up or down,
    computed here a coordinate and a direction a call; ulp_ratio reads the
    largest error over spread (or 4 ulps of max|want|) by coordinate.  The
    calls here stack their particles as often as ulp_spread's one call does:
    the plain version rounds each particle alike within a call, but its AFS
    product may round otherwise at another number of particles."""
    import chip_smoke

    P = N_EDGE + 3
    init = _init(pattern, torch.float32)
    x = _cloud(pattern, P, seed=21).float()
    afs, T = _afs_case(nm1, transform=False)
    afs = None if afs is None else afs.float()
    M = Pattern(pattern).M
    rng = np.random.default_rng(22)
    g = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
         for s in ((P, 7, M), (P,), (P,))]
    plain, spread = chip_smoke.ulp_spread(torch, init, x, afs, T, g)
    n = 2 * x.shape[1] + 1

    def grad(y):
        return assembly.assemble_vjp_plain(
            init, y.repeat(n, 1), afs, T, *(t.repeat(n, *([1] * (t.dim() - 1))) for t in g))[:P]

    want = grad(x)
    assert torch.equal(plain, want)
    brute = torch.zeros_like(want)
    for d in range(x.shape[1]):
        for to in (math.inf, -math.inf):
            moved = x.clone()
            moved[:, d] = torch.nextafter(x[:, d], torch.full_like(x[:, d], to))
            brute = torch.maximum(brute, (grad(moved) - want).abs())
    torch.testing.assert_close(spread, brute, rtol=0, atol=0)
    assert bool((spread > 0).any())

    w64 = want.double()
    k_g = want + 3 * spread  # an error of 3 spreads in every entry
    floor = 4 * EPS32 * w64.abs().amax(0)
    ratio = (3 * spread.double().amax(0)) / torch.maximum(spread.double().amax(0), floor)
    assert chip_smoke.ulp_ratio(torch, k_g, w64, spread) == pytest.approx(float(ratio.max()),
                                                                         rel=1e-6)
    assert chip_smoke.ulp_ratio(torch, want, w64, spread) == 0.0


def test_phase_3c_ulp_resolution_is_its_definition():
    """ulp_resolution: a change of one coordinate by just over its reading
    (over that coordinate's max) fails the one-ulp gate, by just under it
    passes; the median and the worst over the coordinates."""
    import chip_smoke

    gen = torch.Generator().manual_seed(5)
    ref = torch.randn(9, 4, generator=gen, dtype=torch.float64)
    ref[:, 3] *= 1e-3
    spread = torch.rand(9, 4, generator=gen, dtype=torch.float64) * 1e-6
    spread[:, 1] = 0.0  # the 4-ulp floor
    scale = ref.abs().amax(0)
    want = chip_smoke.ULP_GATE * torch.maximum(spread.amax(0), 4 * EPS32 * scale) / scale
    med, worst = chip_smoke.ulp_resolution(torch, ref, spread)
    assert med == pytest.approx(float(want.median())) and worst == pytest.approx(float(want.max()))
    for j in range(4):
        for f, fails in ((1.001, True), (0.999, False)):
            got = ref.clone()
            got[0, j] += f * float(want[j] * scale[j])
            assert (chip_smoke.ulp_ratio(torch, got, ref, spread) > chip_smoke.ULP_GATE) == fails


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    "A1 and A2 against the plain version on a card (chip_smoke.py phase 3c does the full check)."
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 3c runs this check on the card")
    import chip_smoke

    chip_smoke.check_assembly(torch, torch.device("cuda", 0))


# PERF.md's table of hand kernels with no Pallas counterpart, at the fit's
# smc program (500 particles, pattern 14*1+1*2: M = 16, D = 18; its AFS term
# from one diploid, n - 1 = 1 through a one-row transform)
@pytest.mark.parametrize("name, bound_ms, by", [
    ("assembly_forward", "7.88e-05", "bytes"),
    ("assembly_backward", "8.96e-05", "bytes"),
])
def test_roofline_reproduces_the_assembly_table(name, bound_ms, by):
    "Each assembly kernel's bound, to 3 significant figures, and what bounds it."
    from phlash_tpu_torch import roofline

    ms, got_by = roofline.assembly_bound(name, 500, 16, 18, nm1=1, R=1)
    assert f"{ms:.3g}" == bound_ms and got_by == by
    ms64, _ = roofline.assembly_bound(name, 500, 16, 18, nm1=1, R=1, elem=8)
    assert ms64 > ms  # float64: twice the bytes, half the peak rate
    with pytest.raises(ValueError, match="unknown assembly kernel"):
        roofline.assembly_bound("assembly", 500, 16, 18)
