"""Static posterior plotting: port of phlash_tpu/plot.py:12-52.

matplotlib is optional, and imported only when no axis is given.
"""

from __future__ import annotations

import numpy as np
import torch

from phlash_tpu_torch.size_history import DemographicModel, SizeHistory


def plot_posterior(
    dms: list[DemographicModel],
    ax=None,
    credible_width: float = 0.95,
    generations: bool = True,
    **kwargs,
):
    """Plot the posterior median Ne(t) and a pointwise credible band.

    Args:
        dms: posterior samples from fit().
        ax: matplotlib axis (defaults to the current one).
        credible_width: width of the pointwise band (None to disable).

    Returns:
        (t, median Ne, (lower, upper) or None), as numpy arrays.
    """
    if ax is None:
        import matplotlib.pyplot as plt

        ax = plt.gca()
    eta = SizeHistory(t=torch.stack([dm.eta.t for dm in dms]),
                      c=torch.stack([dm.eta.c for dm in dms]))
    # evaluate between the 2.5% and 97.5% posterior time quantiles
    q_lo = np.quantile(eta.t[:, 1].cpu().numpy(), 0.025)
    q_hi = np.quantile(eta.t[:, -1].cpu().numpy(), 0.975)
    t = np.geomspace(max(q_lo, 1e-8), q_hi, 200)
    Ne = eta(torch.from_numpy(t), Ne=True).cpu().numpy()
    med = np.median(Ne, axis=0)
    ax.plot(t, med, **kwargs)
    band = None
    if credible_width is not None:
        half = (1.0 - credible_width) / 2.0
        lo = np.quantile(Ne, half, axis=0)
        hi = np.quantile(Ne, 1.0 - half, axis=0)
        ax.fill_between(t, lo, hi, alpha=0.2, color=kwargs.get("color"))
        band = (lo, hi)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("Time" + (" (generations)" if generations else ""))
    ax.set_ylabel("$N_e$")
    return t, med, band
