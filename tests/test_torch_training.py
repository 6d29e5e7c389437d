"""The port's fit loop on the CPU: make_multi_step and the call against
sequential steps and against phlash_tpu's SVGD steps, the steps_per_call
default, the ELPD's own generator, the best-state snapshot, and the step
constants built once per device."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.flatten_util import ravel_pytree

from phlash_tpu.model import log_density_batched as jax_log_density
from phlash_tpu.ops.kernel_dense import DenseKernel
from phlash_tpu.svgd import SVGD as JaxSVGD
from phlash_tpu_torch import convert, mcmc, params, size_history, training
from phlash_tpu_torch.data import RawContig
from phlash_tpu_torch.ops.kernel_smc import SMCKernel
from phlash_tpu_torch.svgd import SVGD, AMSGrad, SVGDState
from phlash_tpu_torch.training import Caller, make_multi_step, resolve_steps_per_call

OVERLAP, BODY, N_CHUNKS = 40, 120, 4
C = (1.0, 2.0, 1.0)
INDS = np.array([[0, 2], [1, 3], [3, 3]])  # k = 3 rows of S = 2 chunk indices


@pytest.fixture(scope="module")
def chunks():
    rng = np.random.default_rng(2)
    d = rng.binomial(1, 0.05, size=(N_CHUNKS, OVERLAP + BODY)).astype(np.int8)
    d[1, 60:90] = -1
    return d


@pytest.fixture(scope="module")
def jm(mcp):
    "5 JAX particles around the fixture, float64."
    flat, unravel = ravel_pytree(mcp)
    draws = np.asarray(flat)[None] + 0.3 * np.random.default_rng(3).standard_normal((5, flat.size))
    return jax.vmap(unravel)(jnp.asarray(draws))


def _torch_step(jm, chunks):
    "(state, base_step) of the port at float64 on the CPU, on the smc backend."
    tm = convert.from_reference_mcmc(jm)
    svgd = SVGD(training.batched_grad(tm), AMSGrad(learning_rate=0.1))
    kern = SMCKernel(16, chunks[:, OVERLAP:], device="cpu")
    warm = torch.as_tensor(chunks[:, :OVERLAP])

    def base_step(state, inds):
        return svgd.step(state, c=C, inds=inds, warmup=warm[inds], kern=kern, afs=None)

    return svgd.init(tm.flatten()), base_step


def test_multi_step_equals_sequential_steps(jm, chunks):
    """make_multi_step over k = 3 index rows, and a Caller's call on the CPU,
    equal three sequential base_steps bit for bit (float64): the
    counterpart of tests/test_training.py::test_multi_step_equals_sequential_steps."""
    state, base_step = _torch_step(jm, chunks)
    inds = torch.as_tensor(INDS)
    seq = state
    for row in inds:
        seq = base_step(seq, row)
    multi = make_multi_step(base_step, 3)(state, inds)
    called, elpd = Caller(base_step)(state, inds)
    assert elpd is None
    for a, b, c in zip(seq.tensors(), multi.tensors(), called.tensors()):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_multi_step_matches_jax_svgd(jm, chunks):
    """The same three steps against phlash_tpu's SVGD step (optax.amsgrad,
    the dense kernel) on the same particles and indices: particles and
    moments to 1e-9 at float64, with the amsgrad count a 0-d tensor."""
    kern = DenseKernel(M=16, data=chunks[:, OVERLAP:], double_precision=True)

    def density(P, **kw):
        return jax_log_density(P, kern=kern, afs=None, **kw).sum()

    jsvgd = JaxSVGD(jax.grad(density), optax.amsgrad(0.1), batched_grad=True)
    jstep = jax.jit(lambda s, i, w: jsvgd.step(s, c=jnp.asarray(C), inds=i, warmup=w))
    jstate = jsvgd.init(jm)
    for row in INDS:
        jstate = jstep(jstate, jnp.asarray(row), jnp.asarray(chunks[row, :OVERLAP]))

    state, base_step = _torch_step(jm, chunks)
    got = make_multi_step(base_step, 3)(state, torch.as_tensor(INDS))
    flat = lambda tree: np.asarray(jax.vmap(lambda m: ravel_pytree(m)[0])(tree))  # noqa: E731
    np.testing.assert_allclose(got.particles.numpy(), flat(jstate.particles), rtol=1e-9,
                               atol=1e-9)
    amsgrad = jstate.opt_state[0]  # optax's ScaleByAmsgradState
    for ours, theirs in ((got.opt_state.mu, amsgrad.mu), (got.opt_state.nu, amsgrad.nu)):
        np.testing.assert_allclose(ours.numpy(), flat(theirs), rtol=1e-9, atol=1e-12)
    count = got.opt_state.count
    assert count.shape == () and count.dtype == torch.int64 and int(count) == 3
    assert int(amsgrad.count) == 3


@pytest.mark.parametrize("device,option,niter,want", [
    ("cpu", None, 20, 1), ("cuda", None, 20, 10), ("cuda", None, 4, 4), ("cpu", 3, 20, 3),
    ("cuda", 0, 20, 1),
])
def test_resolve_steps_per_call(device, option, niter, want):
    "10 on CUDA and 1 on the CPU unless given, capped at niter, at least 1."
    assert resolve_steps_per_call(option, device, niter) == want


@pytest.fixture(scope="module")
def contigs():
    "Two training contigs and one held out, 3000 windows of Bernoulli(0.05) hets."
    rng = np.random.default_rng(5)
    het = [(rng.random((1, 3000)) < 0.05).astype(np.int8) for _ in range(3)]
    return [RawContig(het_matrix=h, afs=np.ones(1), window_size=100) for h in het]


FIT = dict(device="cpu", kernel_backend="smc", num_particles=6, chunk_size=300, overlap=30,
           minibatch_size=2, progress=False)


def _c(models):
    return np.stack([m.eta.c.numpy() for m in models])


def test_fit_elpd_leaves_the_step_stream_alone(contigs):
    """With and without held-out data (its ELPD subsets come from their own
    generator), with steps_per_call 3 and a partial final call (7 = 3 + 3 +
    1): identical final models."""
    train, held = contigs[:2], contigs[2]
    kw = dict(FIT, niter=7, steps_per_call=3, return_final=True, elpd_samples=2)
    with_elpd = mcmc.fit(train, held, **kw)
    without = mcmc.fit(train, **kw)
    np.testing.assert_array_equal(_c(with_elpd), _c(without))
    assert np.isfinite(_c(with_elpd)).all()


class StaticCaller(Caller):
    """A Caller whose CPU calls keep the state in static tensors updated in
    place, as its CUDA graphs do."""

    def __call__(self, state, inds, elpd_inds=None):
        new, elpd = self.run(state, inds, elpd_inds)
        if self.state is None:
            self.state = training.clone_state(new)
        else:
            training._copy_into(self.state, new)
        return self.state, elpd


def test_best_state_is_a_snapshot(contigs, monkeypatch):
    """The best-ELPD particles are a copy: with the state updated in place
    (as on CUDA), the particles returned at the best ELPD (the only
    evaluation, after the first iteration) are those after one iteration,
    not the last ones."""
    monkeypatch.setattr(mcmc, "Caller", StaticCaller)
    monkeypatch.setattr(training, "Caller", StaticCaller)
    train, held = contigs[:2], contigs[2]
    kw = dict(FIT, chunk_size=600)  # 10 chunks: no run below caps them (5 * S * niter)
    best = mcmc.fit(train, held, niter=4, **kw)
    last = mcmc.fit(train, held, niter=4, return_final=True, **kw)
    first = mcmc.fit(train, niter=1, return_final=True, **kw)
    np.testing.assert_array_equal(_c(best), _c(first))
    assert not np.array_equal(_c(best), _c(last))


@pytest.mark.parametrize("n", [2, 5, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_step_constants_are_cached_and_bit_identical(n, dtype):
    """The etjj / etbl constants and the pattern's index, built once per
    (n, dtype, device), equal a fresh build bit for bit, and etbl through
    them equals etbl through a fresh W."""
    dev = torch.device("cpu")
    j = np.arange(2, n + 1)
    m = size_history._pair_counts(n, dtype, dev)
    assert torch.equal(m, torch.as_tensor(j * (j - 1) // 2, dtype=dtype))
    assert m is size_history._pair_counts(n, dtype, dev)
    W = size_history._W_tensor(n, dtype, dev)
    assert torch.equal(W, torch.as_tensor(size_history._W_matrix(n), dtype=dtype))
    assert W is size_history._W_tensor(n, dtype, dev)
    rng = np.random.default_rng(n)
    eta = size_history.SizeHistory(
        t=torch.as_tensor(np.concatenate([[0.0], np.cumsum(rng.random(6))]), dtype=dtype),
        c=torch.as_tensor(rng.random(7) + 0.5, dtype=dtype))
    fresh = eta.etjj(n) @ torch.as_tensor(size_history._W_matrix(n), dtype=dtype).T
    assert torch.equal(eta.etbl(n), fresh)
    idx = params._expand_index("14*1+1*2", dev)
    assert idx.tolist() == list(range(15)) + [14]
    assert idx is params._expand_index("14*1+1*2", dev)


def test_caller_state_roundtrip_helpers():
    "SVGDState.tensors / from_tensors and the Caller's clone and copy keep every piece."
    p = torch.arange(6.0).reshape(3, 2)
    s = AMSGrad(0.1).init(p)
    s = SVGDState(particles=p, opt_state=s)
    c = training.clone_state(s)
    assert all(torch.equal(a, b) and a is not b for a, b in zip(c.tensors(), s.tensors()))
    d = SVGDState.from_tensors(torch.full_like(t, 7) for t in s.tensors())
    training._copy_into(c, d)
    assert all(torch.equal(a, b) for a, b in zip(c.tensors(), d.tensors()))
    assert torch.equal(s.particles, p)
