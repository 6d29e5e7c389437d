"""The phlash_tpu.fit options the port implements: init, afs_transform and
double_precision_params against phlash_tpu's build_training (the initial
cloud's centre and the first SVGD step, float64), truth, max_samples,
double_precision, kernel_seg_len and callback, and the float32 cast at the
CUDA ops' boundary."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

from phlash_tpu.params import MCMCParams as JMCMCParams
from phlash_tpu.training import build_training as jax_build_training
from phlash_tpu_torch import convert, mcmc, sim
from phlash_tpu_torch.data import RawContig, chunk_het_matrix
from phlash_tpu_torch.hmm import ScanKernel
from phlash_tpu_torch.ops import build, packed, smc
from phlash_tpu_torch.ops.kernel_dense import DenseKernel
from phlash_tpu_torch.ops.kernel_packed import packed_op
from phlash_tpu_torch.ops.kernel_smc import smc_op
from phlash_tpu_torch.ops.packing import dense_transition
from phlash_tpu_torch.params import MCMCParams, PSMCParams
from phlash_tpu_torch.svgd import AMSGrad, SVGDState
from phlash_tpu_torch.training import build_training

OVERLAP, BODY, N_CHUNKS = 30, 90, 6
AFS = np.array([7.0, 4.0, 2.0])  # n = 4
BASE = dict(niter=4, num_particles=5, minibatch_size=2, learning_rate=0.1, sigma=0.5,
            double_precision_params=True, double_precision=True)


@pytest.fixture(scope="module")
def chunks():
    rng = np.random.default_rng(11)
    d = rng.binomial(1, 0.05, size=(N_CHUNKS, OVERLAP + BODY)).astype(np.int8)
    d[2, 40:70] = -1
    return d


def _jax_init():
    return JMCMCParams.from_linear(pattern="14*1+1*2", t1=3e-4, tM=9.0,
                                   c=np.linspace(0.6, 1.7, 15), theta=1.3e-2, rho=0.9e-2)


# option -> (the port's value, phlash_tpu's value)
PARITY = {
    "init": lambda: (convert.from_reference_mcmc(_jax_init()), _jax_init()),
    "afs_transform": lambda: (np.array([[1.0, 0.5, 0.0], [0.0, 0.5, 1.0]]),) * 2,
    "double_precision_params": lambda: (True, True),
}


@pytest.mark.parametrize("option", sorted(PARITY))
@pytest.mark.parametrize("backend", ["dense", "scan"])
def test_build_training_matches_jax(chunks, option, backend):
    """build_training with `option` against phlash_tpu's at float64 on the
    CPU (the dense backend on its side): the initial cloud's centre and
    dtype, the cloud as centre + sqrt(sigma) * the generator's normal draws,
    and, from phlash_tpu's initial particles and minibatch, the first SVGD
    step's particles at 1e-10 (amsgrad's first step, lr * g / (|g| + eps),
    is insensitive to phlash_tpu's float32 AFS term)."""
    ours_v, theirs_v = PARITY[option]()
    kw = dict(window_size=100, overlap=OVERLAP)
    jprog = jax_build_training(chunks, AFS, key=jax.random.PRNGKey(3),
                               options=dict(BASE, kernel_backend="dense", **{option: theirs_v}),
                               **kw)
    gen = torch.Generator().manual_seed(3)
    prog = build_training(chunks, AFS, device=torch.device("cpu"), generator=gen,
                          kernel_backend=backend, options=dict(BASE, **{option: ours_v}), **kw)
    x0 = prog.init.flatten()
    assert x0.dtype == prog.state.particles.dtype == torch.float64
    np.testing.assert_allclose(x0.numpy(), np.asarray(ravel_pytree(jprog.init)[0]), rtol=1e-10)
    noise = torch.randn(BASE["num_particles"], x0.shape[-1], generator=torch.Generator()
                        .manual_seed(3), dtype=torch.float64)
    torch.testing.assert_close(prog.state.particles, x0 + BASE["sigma"] ** 0.5 * noise,
                               rtol=1e-15, atol=1e-15)
    if option == "afs_transform":
        np.testing.assert_array_equal(prog.afs_transform.numpy(), ours_v)

    key = jax.random.PRNGKey(5)
    jstate = jax.jit(jprog.base_step)(jprog.state, key)
    inds = torch.as_tensor(np.array(jax.random.choice(key, jprog.N, shape=(jprog.S,))))
    p0 = torch.as_tensor(np.asarray(jax.vmap(lambda m: ravel_pytree(m)[0])(jprog.state.particles)))
    state = SVGDState(particles=p0, opt_state=AMSGrad(0.1).init(p0))
    got = prog.base_step(state, inds).particles
    want = np.asarray(jax.vmap(lambda m: ravel_pytree(m)[0])(jstate.particles))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_float32_cloud_by_default(chunks):
    "Without double_precision_params the cloud, its centre and the AFS constants are float32."
    prog = build_training(chunks, AFS, window_size=100, overlap=OVERLAP,
                          device=torch.device("cpu"), generator=torch.Generator().manual_seed(0),
                          options=dict(niter=2, num_particles=3))
    assert prog.state.particles.dtype == prog.init.t_tr.dtype == torch.float32
    assert prog.afs.dtype == prog.afs_transform.dtype == torch.float32


def test_init_must_be_the_ports_params(chunks):
    with pytest.raises(TypeError, match="MCMCParams"):
        build_training(chunks, AFS, window_size=100, overlap=OVERLAP, device=torch.device("cpu"),
                       generator=torch.Generator(), options=dict(init=_jax_init()))


@pytest.fixture(scope="module")
def contigs():
    "Two training contigs of 1500 windows and a held-out one of 4 rows."
    rng = np.random.default_rng(12)
    train = [RawContig(het_matrix=(rng.random((1, 1500)) < 0.05).astype(np.int8), afs=np.ones(1),
                       window_size=100) for _ in range(2)]
    held = RawContig(het_matrix=(rng.random((4, 1500)) < 0.05).astype(np.int8), afs=np.ones(1),
                     window_size=100)
    return train, held


FIT = dict(device="cpu", num_particles=4, chunk_size=300, overlap=30, minibatch_size=2,
           progress=False)


def _c(models):
    return np.stack([m.eta.c.numpy() for m in models])


def test_truth_sets_the_mutation_rate(contigs):
    """truth=dm fits as mutation_rate=dm.theta (models in generations), and
    giving both raises ValueError."""
    truth = sim.constant_demography(theta=1.25e-8)
    with_truth = mcmc.fit(contigs[0], niter=2, truth=truth, **FIT)
    with_rate = mcmc.fit(contigs[0], niter=2, mutation_rate=1.25e-8, **FIT)
    np.testing.assert_array_equal(_c(with_truth), _c(with_rate))
    assert with_truth[0].theta == 1.25e-8 and float(with_truth[0].eta.t[-1]) > 1e3
    with pytest.raises(ValueError, match="already known from truth"):
        mcmc.fit(contigs[0], niter=1, truth=truth, mutation_rate=1e-8, **FIT)


def test_max_samples_caps_held_out_rows(contigs):
    """max_samples=2 chunks only the first two held-out rows; JAX's default,
    20, is accepted and keeps all four."""
    train, held = contigs
    prog = build_training(chunk_het_matrix(train[0].het_matrix, 30, 270), None, window_size=100,
                          overlap=30, device=torch.device("cpu"),
                          generator=torch.Generator().manual_seed(0),
                          options=dict(niter=2, num_particles=3))
    per_row = len(chunk_het_matrix(held.het_matrix[:1], 30, 270))
    for cap, rows in ((2, 2), (20, 4), (1, 1)):
        elpd = mcmc.held_out_elpd(prog, held, span=300, overlap=30, elpd_samples=None,
                                  device=torch.device("cpu"), kernel_backend="smc",
                                  max_samples=cap)
        assert elpd.N == rows * per_row == len(elpd.kern.data)
    models = mcmc.fit(train, held, niter=2, max_samples=20, **FIT)
    assert len(models) == 4


@pytest.mark.parametrize("backend", ["smc", "packed"])
def test_double_precision_refused_on_the_cuda_kernels(backend):
    "double_precision=True on smc / packed raises ValueError before any data are read."
    with pytest.raises(ValueError, match="float32-only"):
        mcmc.fit([], device="cpu", kernel_backend=backend, overlap=0, double_precision=True)


@pytest.mark.parametrize("backend,cls", [("scan", ScanKernel), ("dense", DenseKernel)])
def test_double_precision_accepted_on_plain_backends(contigs, backend, cls):
    """double_precision=True on scan / dense: a float32 cloud's kernel runs
    in float64, and the fit returns finite models."""
    prog = build_training(chunk_het_matrix(contigs[0][0].het_matrix, 30, 270), None,
                          window_size=100, overlap=30, device=torch.device("cpu"),
                          generator=torch.Generator().manual_seed(0), kernel_backend=backend,
                          options=dict(niter=2, num_particles=3, double_precision=True))
    assert isinstance(prog.kern, cls) and prog.kern.double_precision
    assert prog.state.particles.dtype == torch.float32
    models = mcmc.fit(contigs[0], niter=1, kernel_backend=backend, double_precision=True, **FIT)
    assert np.isfinite(_c(models)).all()


def test_kernel_seg_len(contigs):
    """An int sets the dense backend's segment; "auto" on smc is a no-op
    (the same fit as without it); an int on smc, packed or scan raises."""
    train = contigs[0]
    prog = build_training(chunk_het_matrix(train[0].het_matrix, 30, 270), None, window_size=100,
                          overlap=30, device=torch.device("cpu"),
                          generator=torch.Generator().manual_seed(0), kernel_backend="dense",
                          options=dict(niter=2, num_particles=3, kernel_seg_len=64))
    assert prog.kern.seg_len == 64
    auto = mcmc.fit(train, niter=2, kernel_backend="smc", kernel_seg_len="auto", **FIT)
    plain = mcmc.fit(train, niter=2, kernel_backend="smc", **FIT)
    np.testing.assert_array_equal(_c(auto), _c(plain))
    for backend, overlap in (("smc", 30), ("packed", 0), ("scan", 30)):
        with pytest.raises(ValueError, match="segment length"):
            mcmc.fit([], device="cpu", kernel_backend=backend, overlap=overlap,
                     kernel_seg_len=128)


def test_callback_once_a_call(contigs):
    """callback gets the cloud once a call (niter 5 in calls of 2: 3 calls)
    as one DemographicModel with (P, M) leaves in the returned models' units;
    the last call's cloud is what fit returns."""
    seen = []
    models = mcmc.fit(contigs[0], niter=5, steps_per_call=2, mutation_rate=1e-8,
                      callback=seen.append, return_final=True, **FIT)
    assert len(seen) == 3
    for dm in seen:
        assert dm.eta.t.shape == dm.eta.c.shape == (4, 16) and dm.rho.shape == (4,)
        assert dm.theta == 1e-8 and dm.eta.t.device.type == "cpu"
    np.testing.assert_array_equal(seen[-1].eta.c.numpy(), _c(models))
    assert not np.array_equal(seen[0].eta.c.numpy(), seen[-1].eta.c.numpy())


def _probe(monkeypatch, module, names):
    "Record the dtypes of the float tensors each of `names` of `module` is called with."
    seen = []
    for name in names:
        real = getattr(module, name)

        def probe(*args, _real=real, **kw):
            flat = [a for a in args if isinstance(a, torch.Tensor)]
            flat += [x for a in args if isinstance(a, tuple) for x in a]
            seen.append({x.dtype for x in flat if x.is_floating_point()})
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, probe)
    return seen


def test_smc_op_casts_at_the_kernel_boundary(monkeypatch):
    """With the kernels' dtype float32 (as on CUDA), a float64 graph reaches
    the forward and adjoint only in float32; the outputs come back float64
    and the gradients float64, equal to those of the float32 inputs."""
    monkeypatch.setitem(build.KERNEL_DTYPE, "cpu", torch.float32)
    seen = _probe(monkeypatch, smc, ("forward", "backward"))
    dm = sim.bottleneck_demography()
    pp = PSMCParams.from_dm(dm)
    leaves = {k: getattr(pp, k).expand(2, -1).clone().requires_grad_(True)
              for k in ("b", "d", "u", "v", "emis0", "emis1")}
    pi = pp.pi.expand(2, 3, -1).clone().requires_grad_(True)
    obs = torch.as_tensor(np.random.default_rng(0).binomial(1, 0.05, (3, 40)), dtype=torch.int8)
    ll, alpha = smc_op(PSMCParams(**leaves, pi=pp.pi), pi, obs)
    assert ll.dtype == alpha.dtype == torch.float64
    grads = torch.autograd.grad(ll.sum() + alpha.sum(), [*leaves.values(), pi])
    assert all(g.dtype == torch.float64 for g in grads)
    assert seen == [{torch.float32}, {torch.float32}]

    monkeypatch.setitem(build.KERNEL_DTYPE, "cpu", None)
    l32 = {k: v.detach().float().requires_grad_(True) for k, v in leaves.items()}
    p32 = pi.detach().float().requires_grad_(True)
    ll32, a32 = smc_op(PSMCParams(**l32, pi=pp.pi.float()), p32, obs)
    g32 = torch.autograd.grad(ll32.sum() + a32.sum(), [*l32.values(), p32])
    torch.testing.assert_close(ll, ll32.double(), rtol=0, atol=0)
    for a, b in zip(grads, g32):
        torch.testing.assert_close(a, b.double(), rtol=0, atol=0)


def test_packed_op_casts_at_the_kernel_boundary(monkeypatch):
    "The same for the packed pair: float32 at B4 and B5, float64 out and back."
    monkeypatch.setitem(build.KERNEL_DTYPE, "cpu", torch.float32)
    seen = _probe(monkeypatch, packed, ("forward", "backward"))
    pp = PSMCParams.from_dm(sim.bottleneck_demography())
    A = dense_transition(pp.replace(**{k: getattr(pp, k)[None] for k in ("b", "d", "u", "v")}))
    A = A.clone().requires_grad_(True)
    e0, e1 = (getattr(pp, k)[None].clone().requires_grad_(True) for k in ("emis0", "emis1"))
    pi = pp.pi.expand(1, 2, -1).clone().requires_grad_(True)
    obs = torch.as_tensor(np.random.default_rng(1).binomial(1, 0.05, (2, 32)), dtype=torch.int8)
    ll = packed_op(A, e0, e1, pi, obs)
    grads = torch.autograd.grad(ll.sum(), [A, e0, e1, pi])
    assert ll.dtype == torch.float64 and all(g.dtype == torch.float64 for g in grads)
    assert seen == [{torch.float32}, {torch.float32}]


@pytest.mark.parametrize("debug", [None, "1"], ids=["unset", "set"])
def test_check_every_default_follows_phlash_tpu_debug(contigs, monkeypatch, debug):
    """fit's default check_every is phlash_tpu's: 1 with PHLASH_TPU_DEBUG set,
    10 without (phlash_tpu/mcmc.py's rule, read from its fit and evaluated
    here); an explicit check_every wins either way."""
    import inspect
    import os
    import re

    from phlash_tpu import mcmc as jax_mcmc

    if debug is None:
        monkeypatch.delenv("PHLASH_TPU_DEBUG", raising=False)
    else:
        monkeypatch.setenv("PHLASH_TPU_DEBUG", debug)
    rule = re.search(r"default_check = (.+)", inspect.getsource(jax_mcmc.fit)).group(1)
    want = eval(rule, {"_os": os})
    assert mcmc.default_check_every() == want == (1 if debug else 10)

    checked = []
    real = mcmc._check_finite
    monkeypatch.setattr(mcmc, "_check_finite",
                        lambda p, mesh, i: (checked.append(i), real(p, mesh, i)))
    mcmc.fit(contigs[0], niter=4, **FIT)  # one iteration a call on the CPU
    assert checked == ([0, 1, 2, 3] if debug else [0, 3])
    checked.clear()
    mcmc.fit(contigs[0], niter=4, check_every=2, **FIT)
    assert checked == [0, 2, 3]
