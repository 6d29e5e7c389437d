"""Parameterizations: optimization coordinates vs. HMM natural parameters.

Port of phlash_tpu/params.py:34-160.

* ``MCMCParams``: the unconstrained SVGD coordinates (log time-grid
  endpoints, inverse-softplus coalescence rates tied by a pattern string, a
  logit-squashed rho/theta), with leading particle axes.  `flatten` and
  `unflatten` use the leaf order of JAX's `ravel_pytree` on the reference
  class: t_tr (2), c_tr (K), rho_over_theta_tr (1).
* ``PSMCParams``: the O(M) compressed SMC' transition (b, d, u, v), the
  emissions and the initial distribution pi that the HMM kernels consume.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from phlash_tpu_torch import size_history, transition
from phlash_tpu_torch.utils import Pattern, softplus, softplus_inv

PSMC_FIELDS = ("b", "d", "u", "v", "emis0", "emis1", "pi")


@functools.lru_cache(maxsize=32)
def _expand_index(pattern: str, device: torch.device) -> torch.Tensor:
    """Pattern(pattern).expand as an index on `device`, built once and shared
    read-only: indexing a device tensor by the numpy index would copy it
    from the host at every call, which a CUDA graph capture does not allow."""
    pat = Pattern(pattern)
    return torch.as_tensor(pat.expand(np.arange(len(pat))), device=device)


@dataclass(frozen=True)
class PSMCParams:
    b: torch.Tensor  # (..., M) sub-diagonal (column-constant lower triangle factor)
    d: torch.Tensor  # (..., M) diagonal
    u: torch.Tensor  # (..., M) row factor of the rank-one upper triangle
    v: torch.Tensor  # (..., M) column factor of the rank-one upper triangle
    emis0: torch.Tensor  # (..., M) P(obs = 0 | state)
    emis1: torch.Tensor  # (..., M) P(obs = 1 | state)
    pi: torch.Tensor  # (..., M) initial distribution (per chunk: (..., S, M))

    def replace(self, **kw) -> "PSMCParams":
        return dataclasses.replace(self, **kw)

    @property
    def M(self) -> int:
        return self.d.shape[-1]

    def to(self, dtype=None, device=None) -> "PSMCParams":
        "Every leaf cast (differentiably) to `dtype` and `device`."
        return PSMCParams(*(getattr(self, k).to(dtype=dtype, device=device) for k in PSMC_FIELDS))

    @classmethod
    def from_dm(cls, dm: size_history.DemographicModel) -> "PSMCParams":
        """Compress a demographic model into HMM natural parameters: binomial
        emissions in theta * E[coal time in interval]; the transition read off
        its diagonals, with the rank-one upper triangle factored from row 0."""
        lam = dm.theta * dm.eta.ect()
        clip = lambda a: a.clamp(1e-20, 1.0 - 1e-20)  # noqa: E731
        emis0 = clip(torch.exp(-lam))
        emis1 = clip(-torch.expm1(-lam))
        pi = clip(dm.eta.pi)
        A = clip(transition.transition_matrix(dm))
        sub = torch.diagonal(A, -1, -2, -1)
        diag = torch.diagonal(A, 0, -2, -1)
        sup = torch.diagonal(A, 1, -2, -1)
        v = A[..., 0, 1:] / A[..., 0, 1:2]
        u = sup / v
        zero = torch.zeros_like(diag[..., :1])
        return cls(
            b=torch.cat([sub, zero], -1),
            d=diag,
            u=torch.cat([u, zero], -1),
            v=torch.cat([zero, v], -1),
            emis0=emis0,
            emis1=emis1,
            pi=pi,
        )


@dataclass(frozen=True)
class MCMCParams:
    """Unconstrained SVGD coordinates; tensors carry leading particle axes.

    Trainable: t_tr (..., 2), c_tr (..., K), rho_over_theta_tr (...).
    Static: pattern, theta, alpha (smoothness), beta (ridge).
    """

    t_tr: torch.Tensor  # [log t1, log (tM - t1)]
    c_tr: torch.Tensor  # softplus^-1 of the tied coalescence rates
    rho_over_theta_tr: torch.Tensor  # logit((rho/theta - 0.1) / 9.9)
    pattern: str
    theta: float
    alpha: float
    beta: float

    @classmethod
    def from_linear(cls, pattern: str, t1: float, tM: float, c, theta: float, rho: float,
                    alpha: float = 0.0, beta: float = 0.0, dtype=torch.float64,
                    device="cpu") -> "MCMCParams":
        assert len(Pattern(pattern)) == len(c), "one c entry per tied group"
        as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
        t1_, tM_ = as_t(t1), as_t(tM)
        return cls(
            t_tr=torch.stack([torch.log(t1_), torch.log(tM_ - t1_)]),
            c_tr=softplus_inv(as_t(c)),
            rho_over_theta_tr=torch.logit(as_t((rho / theta - 0.1) / 9.9)),
            pattern=pattern,
            theta=float(theta),
            alpha=float(alpha),
            beta=float(beta),
        )

    def to(self, dtype=None, device=None) -> "MCMCParams":
        f = lambda x: x.to(dtype=dtype, device=device)  # noqa: E731
        return dataclasses.replace(
            self, t_tr=f(self.t_tr), c_tr=f(self.c_tr), rho_over_theta_tr=f(self.rho_over_theta_tr)
        )

    # -- flat coordinates (ravel_pytree leaf order) ---------------------------
    def flatten(self) -> torch.Tensor:
        "(..., D) flat coordinates."
        return torch.cat([self.t_tr, self.c_tr, self.rho_over_theta_tr[..., None]], -1)

    def unflatten(self, flat: torch.Tensor) -> "MCMCParams":
        "Coordinates (..., D) back into a params object with this one's statics."
        K = self.c_tr.shape[-1]
        return dataclasses.replace(
            self, t_tr=flat[..., :2], c_tr=flat[..., 2 : 2 + K],
            rho_over_theta_tr=flat[..., 2 + K],
        )

    # -- constrained views ------------------------------------------------------
    @property
    def t(self):
        "Grid endpoints (t1, tM); parameterized so tM > t1 > 0 always."
        e = torch.exp(self.t_tr)
        t1, dtM = e[..., 0], e[..., 1]
        return t1, t1 + dtM

    @property
    def c(self):
        return softplus(self.c_tr)

    @property
    def log_c(self):
        return torch.log(self.c)

    @property
    def rho_over_theta(self):
        "Squashed to [0.1, 10]."
        return 0.1 + 9.9 * torch.sigmoid(self.rho_over_theta_tr)

    @property
    def rho(self):
        return self.rho_over_theta * self.theta

    @property
    def M(self) -> int:
        return Pattern(self.pattern).M

    def to_dm(self) -> size_history.DemographicModel:
        "Expand to a demographic model on a geometric time grid."
        pat = Pattern(self.pattern)
        t1, tM = self.t
        lo, hi = torch.log(t1)[..., None], torch.log(tM)[..., None]
        k = torch.arange(pat.M - 1, dtype=t1.dtype, device=t1.device) / (pat.M - 2)
        grid = torch.exp(lo + (hi - lo) * k)  # geomspace(t1, tM, M - 1)
        t = torch.cat([torch.zeros_like(lo), grid], -1)
        c = self.c[..., _expand_index(self.pattern, self.c.device)]  # pat.expand(self.c)
        eta = size_history.SizeHistory(t=t, c=c)
        return size_history.DemographicModel(eta=eta, theta=self.theta, rho=self.rho)
