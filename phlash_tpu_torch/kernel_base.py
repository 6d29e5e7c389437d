"""What the four likelihood kernels share: their device and the per-particle entries.

The kernels (hmm.ScanKernel, ops/kernel_dense.DenseKernel,
ops/kernel_smc.SMCKernel, ops/kernel_packed.PackedKernel) hold the int8
chunk tensor on `device`, which is a CUDA device unless the caller asks for
the CPU (`resolve_device`: no fallback), and compute through their batched
entry `loglik_rows(pp, rows)`.  `LikelihoodKernel` puts phlash_tpu's
per-particle interface (phlash_tpu/kernel.py:7-9; e.g. phlash_tpu/hmm.py:93-123)
on top of it, as thin wrappers:

    kern.loglik(pp, index)   -> 0-d tensor, differentiable
    kern(pp, index, grad)    -> ll, or (ll, grads) with grads of pp's type
    kern.float_type          -> the dtype it computes in (None: pp's dtype)

pp is a PSMCParams with unbatched (M,) leaves or a DemographicModel (through
PSMCParams.from_dm).  index is a chunk index, 0-d or 1-d.  A 1-d index of n
chunks runs as one batched call at (B, S) = (1, n) and returns ll (n,) and
each chunk's gradient, leaves (n, ...), as
jax.vmap(jax.value_and_grad(loglik), (None, 0)) does in phlash_tpu:
`instance_grads` gives the gradients of the PSMCParams leaves (the hand
kernels keep the per-instance gradients their adjoint produces; the plain
backends take one batched backward pass), and a DemographicModel's are
carried back through from_dm in one batched VJP.
"""

from __future__ import annotations

import torch
from torch import nn

from phlash_tpu_torch import profiling
from phlash_tpu_torch.ops import build
from phlash_tpu_torch.params import PSMC_FIELDS, PSMCParams
from phlash_tpu_torch.size_history import DemographicModel, SizeHistory


def resolve_device(device) -> torch.device:
    "A torch.device for `device`; a CUDA device must exist (no CPU fallback)."
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def upload(data, device) -> torch.Tensor:
    """Chunk rows or warm-up prefixes (int8) on `device`: inside a fit, a
    phlash.start.upload span that counts the copy's bytes (upload_bytes)."""
    with profiling.span("phlash.start.upload"):
        t = torch.as_tensor(data, dtype=torch.int8, device=resolve_device(device))
        profiling.count("upload_bytes", t.nbytes)
    return t


def kernel_dtype(leaves, device: torch.device) -> tuple:
    """The leaves cast to build.KERNEL_DTYPE's entry for `device` (float32 on
    CUDA) by the hand-kernel backends, so a float64 tensor never reaches a
    kernel."""
    dtype = build.KERNEL_DTYPE.get(device.type)
    return tuple(leaves) if dtype is None else tuple(x.to(dtype) for x in leaves)


def one_particle(pp: PSMCParams, n: int) -> PSMCParams:
    "Unbatched leaves (M,) as one particle on n chunks: (1, M), pi (1, n, M)."
    return PSMCParams(*(getattr(pp, k)[None] for k in PSMC_FIELDS[:-1]),
                      pi=pp.pi[None, None].expand(1, n, -1))


def batched_vjp(f, primals: tuple, cotangents: tuple) -> tuple:
    """The VJP of `f` at `primals` for each of a batch of cotangents (leading
    axis n), in one batched call."""
    _, vjp = torch.func.vjp(f, *primals)
    return torch.func.vmap(vjp)(cotangents)


def _from_dm_leaves(t, c, theta, rho) -> tuple:
    dm = DemographicModel(eta=SizeHistory(t=t, c=c), theta=theta, rho=rho)
    pp = PSMCParams.from_dm(dm)
    return tuple(getattr(pp, k) for k in PSMC_FIELDS)


def through_from_dm(dm: DemographicModel, g: PSMCParams) -> DemographicModel:
    """Per-chunk gradients of PSMCParams.from_dm(dm)'s leaves (n, M), carried
    back to dm's: a DemographicModel whose t, c, theta and rho hold n rows."""
    t = dm.eta.t
    theta = torch.as_tensor(dm.theta, dtype=t.dtype, device=t.device)
    rho = torch.as_tensor(dm.rho, dtype=t.dtype, device=t.device)
    gt, gc, gtheta, grho = batched_vjp(_from_dm_leaves, (t, dm.eta.c, theta, rho),
                                       tuple(getattr(g, k) for k in PSMC_FIELDS))
    return DemographicModel(eta=SizeHistory(t=gt, c=gc), theta=gtheta, rho=grho)


class LikelihoodKernel(nn.Module):
    """Base of the likelihood kernels: `data` (N, L) int8 on the kernel's
    device, `loglik_rows` in the subclass; the per-particle entries here."""

    data: torch.Tensor
    double_precision: bool | None = None  # dense / scan set it; the hand-kernel backends not

    def loglik_rows(self, pp: PSMCParams, rows: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def model_loglik_rows(self, pp: PSMCParams, rows: torch.Tensor) -> torch.Tensor:
        """loglik_rows where pp comes from demographic models, as in the fit's
        density: their transition is row-stochastic, so a kernel may stop
        each row at its last observed site (ops/kernel_smc.SMCKernel does);
        the values and the gradients of the models' parameters are the same."""
        return self.loglik_rows(pp, rows)

    def loglik_batched(self, pp: PSMCParams, inds: torch.Tensor) -> torch.Tensor:
        """(B, S) log-likelihoods of chunks `inds` (S,); pp leaves (B, M)
        except pi, (B, S, M): the per-chunk initial distributions."""
        return self.loglik_rows(pp, self.data[inds])

    @property
    def float_type(self) -> torch.dtype | None:
        """The dtype the kernel computes in; None where it is the parameters':
        smc / packed compute in build.KERNEL_DTYPE's entry for their device,
        dense / scan in float64 with double_precision and in pp's dtype without."""
        if self.double_precision is None:
            return build.KERNEL_DTYPE.get(self.data.device.type)
        return torch.float64 if self.double_precision else None

    def loglik(self, pp: PSMCParams | DemographicModel, index) -> torch.Tensor:
        "Log-likelihood (0-d, differentiable) of chunk `index` (a scalar) under pp."
        return self.forward(pp, torch.as_tensor(index).reshape(()), grad=False)

    def instance_grads(self, pp: PSMCParams, rows: torch.Tensor) -> tuple:
        """(ll (n,), gradients of pp's leaves on each chunk, a PSMCParams of
        (n, M) leaves) for unbatched pp on the rows (n, L): one batched
        forward and one batched backward pass."""
        n = rows.shape[0]
        leaves = [getattr(pp, k).detach().requires_grad_(True) for k in PSMC_FIELDS]
        with torch.enable_grad():
            ll = self.loglik_rows(one_particle(PSMCParams(*leaves), n), rows)[0]
        eye = torch.eye(n, dtype=ll.dtype, device=ll.device)
        grads = torch.autograd.grad(ll, leaves, eye, is_grads_batched=True)
        return ll.detach(), PSMCParams(*grads)

    def forward(self, pp: PSMCParams | DemographicModel, index, grad: bool):
        """ll of chunk(s) `index` (0-d or 1-d), or (ll, grads) with grad=True;
        a 1-d index gives ll (n,) and each chunk's gradient (see the module
        docstring)."""
        index = torch.as_tensor(index, device=self.data.device)
        if index.ndim not in (0, 1):
            raise ValueError(f"index must be 0-d or 1-d, got shape {tuple(index.shape)}")
        inds = index.reshape(-1)
        rows = self.data[inds]
        if not grad:
            psmc = PSMCParams.from_dm(pp) if isinstance(pp, DemographicModel) else pp
            ll = self.loglik_rows(one_particle(psmc, len(inds)), rows)[0]
            return ll if index.ndim else ll[0]
        with torch.no_grad():  # the values; the gradients come from instance_grads
            psmc = PSMCParams.from_dm(pp) if isinstance(pp, DemographicModel) else pp
            psmc = PSMCParams(*(getattr(psmc, k).detach() for k in PSMC_FIELDS))
        ll, g = self.instance_grads(psmc, rows)
        if isinstance(pp, DemographicModel):
            g = through_from_dm(pp, g)
        if index.ndim == 0:
            ll, g = ll[0], _first(g)
        return ll, g


def _first(g: PSMCParams | DemographicModel):
    "Row 0 of every leaf."
    if isinstance(g, PSMCParams):
        return PSMCParams(*(getattr(g, k)[0] for k in PSMC_FIELDS))
    return DemographicModel(eta=SizeHistory(t=g.eta.t[0], c=g.eta.c[0]), theta=g.theta[0],
                            rho=g.rho[0])
