"""Posterior serialization: save and load lists of DemographicModel samples.

Port of phlash_tpu/results.py:15-37, in the same .npz layout (`t` and `c`
(P, M), `theta` and `rho` (P,), rho NaN where a model has none), so a file
written by either package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from phlash_tpu_torch.convert import to_numpy
from phlash_tpu_torch.size_history import DemographicModel, SizeHistory



def save_posterior(path: str, posterior: list[DemographicModel]) -> None:
    "Write posterior samples to an .npz file."
    t = np.stack([to_numpy(dm.eta.t) for dm in posterior])
    c = np.stack([to_numpy(dm.eta.c) for dm in posterior])
    theta = np.array([float(dm.theta) for dm in posterior])
    rho = np.array([np.nan if dm.rho is None else float(dm.rho) for dm in posterior])
    np.savez_compressed(path, t=t, c=c, theta=theta, rho=rho)


def load_posterior(path: str) -> list[DemographicModel]:
    "Read posterior samples written by save_posterior (of either package)."
    with np.load(path) as z:
        return [
            DemographicModel(eta=SizeHistory(t=torch.as_tensor(t), c=torch.as_tensor(c)),
                             theta=float(theta), rho=None if np.isnan(rho) else float(rho))
            for t, c, theta, rho in zip(z["t"], z["c"], z["theta"], z["rho"])
        ]
