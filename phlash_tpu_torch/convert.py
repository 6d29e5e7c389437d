"""State exchange with phlash_tpu, without importing it.

Each `from_reference_*` reads an object of phlash_tpu (MCMCParams,
PSMCParams, DemographicModel) through its attributes, as numpy arrays plus
the static fields, and builds the port's counterpart.  Each `*_fields` goes
back: a dict of numpy arrays and statics whose keys are the reference
constructor's arguments, e.g.
``phlash_tpu.params.MCMCParams(**convert.mcmc_fields(mcp))``.
Particle axes carry over unchanged in both directions.
"""

from __future__ import annotations

import numpy as np
import torch

from phlash_tpu_torch.params import PSMC_FIELDS, MCMCParams, PSMCParams
from phlash_tpu_torch.size_history import DemographicModel, SizeHistory


def _t(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.array(x), dtype=dtype, device=device)


def to_numpy(x) -> np.ndarray:
    "A tensor (on any device) or an array-like as a numpy array."
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def from_reference_mcmc(ref, dtype=torch.float64, device="cpu") -> MCMCParams:
    return MCMCParams(
        t_tr=_t(ref.t_tr, dtype, device),
        c_tr=_t(ref.c_tr, dtype, device),
        rho_over_theta_tr=_t(ref.rho_over_theta_tr, dtype, device),
        pattern=ref.pattern,
        theta=float(ref.theta),
        alpha=float(ref.alpha),
        beta=float(ref.beta),
    )


def mcmc_fields(mcp: MCMCParams) -> dict:
    return dict(
        t_tr=to_numpy(mcp.t_tr), c_tr=to_numpy(mcp.c_tr),
        rho_over_theta_tr=to_numpy(mcp.rho_over_theta_tr),
        pattern=mcp.pattern, theta=mcp.theta, alpha=mcp.alpha, beta=mcp.beta,
    )


def from_reference_psmc(ref, dtype=torch.float64, device="cpu") -> PSMCParams:
    return PSMCParams(**{k: _t(getattr(ref, k), dtype, device) for k in PSMC_FIELDS})


def psmc_fields(pp: PSMCParams) -> dict:
    return {k: to_numpy(getattr(pp, k)) for k in PSMC_FIELDS}


def from_reference_dm(ref, dtype=torch.float64, device="cpu") -> DemographicModel:
    eta = SizeHistory(t=_t(ref.eta.t, dtype, device), c=_t(ref.eta.c, dtype, device))
    return DemographicModel(eta=eta, theta=float(ref.theta), rho=_t(ref.rho, dtype, device))


def dm_fields(dm: DemographicModel) -> dict:
    "{'t', 'c', 'theta', 'rho'}: SizeHistory(t, c) and the model's rates."
    return dict(t=to_numpy(dm.eta.t), c=to_numpy(dm.eta.c), theta=dm.theta, rho=to_numpy(dm.rho))
