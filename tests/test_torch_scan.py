"""The port's scan backend (hmm.ScanKernel, kernel_backend="scan") against
phlash_tpu's PureXLAKernel and against the port's SMCKernel (the plain
versions the CPU runs), at float64 with missing data."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from phlash_tpu.hmm import PureXLAKernel
from phlash_tpu.params import PSMCParams as JPSMCParams
from phlash_tpu_torch import convert
from phlash_tpu_torch.hmm import ScanKernel
from phlash_tpu_torch.kernel import KERNELS, get_kernel
from phlash_tpu_torch.ops.kernel_smc import SMCKernel
from phlash_tpu_torch.params import PSMC_FIELDS, PSMCParams
from phlash_tpu_torch.size_history import DemographicModel

B, M, L = 3, 16, 60
INDS = np.array([0, 2, 3])


@pytest.fixture(scope="module")
def sdata():
    "Bernoulli(0.05) rows with a missing block and a missing tail."
    rng = np.random.default_rng(4)
    d = rng.binomial(1, 0.05, size=(4, L)).astype(np.int8)
    d[1, 20:35] = -1
    d[3, 50:] = -1
    return d


@pytest.fixture(scope="module")
def tpp():
    "Port params with (B, M) leaves (perturbed copies of the default model), float64."
    base = PSMCParams.from_dm(DemographicModel.default(pattern=f"{M}*1", theta=1e-2, rho=1e-2))
    scale = 1.0 + 0.05 * torch.linspace(0.0, 1.0, B, dtype=torch.float64)[:, None]
    return base.replace(**{k: (getattr(base, k).expand(B, -1)
                               * (scale if k in ("b", "u") else 1.0)).contiguous()
                           for k in PSMC_FIELDS})


def _pi(tpp):
    "A per-(particle, chunk) initial distribution (B, S, M)."
    w = np.random.default_rng(5).random((B, len(INDS), M)) + 0.5
    pi = tpp.pi.numpy()[:, None, :] * w
    return pi / pi.sum(-1, keepdims=True)


def _leaves(tpp, pi):
    "The port's leaves as autograd leaves: (B, M) params and the (B, S, M) pi."
    leaves = {k: getattr(tpp, k).clone().requires_grad_(True) for k in PSMC_FIELDS[:6]}
    leaves["pi"] = torch.tensor(pi, requires_grad=True)
    return leaves


def test_scan_is_registered():
    "kernel_backend='scan' builds a ScanKernel on the CPU; it is never the default."
    assert KERNELS["scan"] is ScanKernel
    kern = get_kernel(M, np.zeros((2, 8), np.int8), device="cpu", backend="scan")
    assert isinstance(kern, ScanKernel) and not kern.double_precision
    assert not isinstance(get_kernel(M, np.zeros((2, 8), np.int8), device="cpu"), ScanKernel)


def test_loglik_and_grads_match_pure_xla(tpp, sdata):
    """loglik_batched values and the gradients of a weighted sum against
    phlash_tpu's PureXLAKernel at float64, missing data included: rtol 1e-10."""
    pi = _pi(tpp)
    W = np.linspace(0.5, 1.5, B * len(INDS)).reshape(B, len(INDS))
    bc = {k: np.broadcast_to(v[:, None], (B, len(INDS), M))
          for k, v in convert.psmc_fields(tpp).items() if k != "pi"}
    jpps = JPSMCParams(**{k: jnp.asarray(v) for k, v in bc.items()}, pi=jnp.asarray(pi))
    xkern = PureXLAKernel(M=M, data=sdata, double_precision=True)
    g_j = jax.grad(
        lambda p: (xkern.loglik_batched(p, jnp.asarray(INDS)) * W).sum())(jpps)
    ll_rows = xkern.loglik_batched(jpps, jnp.asarray(INDS))

    leaves = _leaves(tpp, pi)
    kern = ScanKernel(M, sdata, device="cpu")
    ll = kern.loglik_batched(PSMCParams(**leaves), torch.as_tensor(INDS))
    assert ll.shape == (B, len(INDS)) and ll.dtype == torch.float64
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(ll_rows), rtol=1e-10)
    gt = torch.autograd.grad((ll * torch.as_tensor(W)).sum(), list(leaves.values()))
    for name, a in zip(leaves, gt):
        b = np.asarray(getattr(g_j, name))
        if name != "pi":
            b = b.sum(1)  # the port's params are shared across the chunk axis
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-14, err_msg=name)


def test_filter_matches_pure_xla(tpp, sdata):
    """filter_batched with the (B, M) leaves that model.log_density_batched
    passes: the filtered states and the gradients of a weighted sum of them
    against phlash_tpu's PureXLAKernel at float64, rtol 1e-10."""
    warmup = sdata[:2, :40]
    T = np.linspace(0.5, 1.5, B * 2 * M).reshape(B, 2, M)
    jpps = JPSMCParams(**{k: jnp.asarray(v) for k, v in convert.psmc_fields(tpp).items()})
    xkern = PureXLAKernel(M=M, data=sdata, double_precision=True)
    g_j = jax.grad(
        lambda p: (xkern.filter_batched(p, jnp.asarray(warmup)) * T).sum())(jpps)
    alpha_j = xkern.filter_batched(jpps, jnp.asarray(warmup))

    leaves = {k: getattr(tpp, k).clone().requires_grad_(True) for k in PSMC_FIELDS}
    alpha = ScanKernel(M, sdata, device="cpu").filter_batched(PSMCParams(**leaves),
                                                              torch.as_tensor(warmup))
    assert alpha.shape == (B, 2, M)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(alpha_j), rtol=1e-10)
    gt = torch.autograd.grad((alpha * torch.as_tensor(T)).sum(), list(leaves.values()))
    for name, a in zip(PSMC_FIELDS, gt):
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(g_j, name)), rtol=1e-10,
                                   atol=1e-14, err_msg=name)


def test_scan_matches_smc_plain(tpp, sdata):
    """ScanKernel against SMCKernel's plain version on the same inputs:
    lls, filtered states and the gradients of both, float64, rtol 1e-10."""
    pi = _pi(tpp)
    W = torch.linspace(0.5, 1.5, B * len(INDS), dtype=torch.float64).reshape(B, len(INDS))
    out = {}
    for name, kern in (("scan", ScanKernel(M, sdata, device="cpu")),
                       ("smc", SMCKernel(M, sdata, device="cpu"))):
        leaves = _leaves(tpp, pi)
        pp = PSMCParams(**leaves)
        ll = kern.loglik_batched(pp, torch.as_tensor(INDS))
        alpha = kern.filter_batched(pp.replace(pi=tpp.pi), torch.as_tensor(sdata[:3, :30]))
        total = (ll * W).sum() + alpha.sum(-1).mul(W).sum()
        out[name] = (ll, alpha, torch.autograd.grad(total, list(leaves.values())))
    (ll_a, al_a, g_a), (ll_b, al_b, g_b) = out["scan"], out["smc"]
    torch.testing.assert_close(ll_a, ll_b, rtol=1e-10, atol=0)
    torch.testing.assert_close(al_a, al_b, rtol=1e-10, atol=1e-300)
    for name, a, b in zip(PSMC_FIELDS, g_a, g_b):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-14, msg=name)


def test_double_precision_casts_float32_params(tpp, sdata):
    """double_precision=True runs a float32 cloud's kernel state in float64
    (the cast is differentiable); without it the scan keeps the parameters'
    dtype."""
    pp32 = tpp.to(torch.float32)
    pi = torch.tensor(_pi(tpp), dtype=torch.float32)
    inds = torch.as_tensor(INDS)
    ll64 = ScanKernel(M, sdata, double_precision=True, device="cpu").loglik_batched(
        pp32.replace(pi=pi), inds)
    ll32 = ScanKernel(M, sdata, device="cpu").loglik_batched(pp32.replace(pi=pi), inds)
    assert ll64.dtype == torch.float64 and ll32.dtype == torch.float32
    want = ScanKernel(M, sdata, device="cpu").loglik_batched(pp32.to(torch.float64).replace(
        pi=pi.double()), inds)
    torch.testing.assert_close(ll64, want, rtol=0, atol=0)
    torch.testing.assert_close(ll32.double(), want, rtol=1e-4, atol=0)
