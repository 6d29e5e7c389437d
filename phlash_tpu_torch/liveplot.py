"""Live monitoring of the posterior during fitting.

Port of phlash_tpu/liveplot.py:18-68.  Inside a Jupyter notebook with
plotly installed, `liveplot_cb` returns a callback that updates a
FigureWidget with the posterior median and 95% band of Ne(t) each time
`fit` hands it the particle cloud; elsewhere it raises ImportError, which
`fit` takes as "no callback".  IPython and plotly are optional.
"""

from __future__ import annotations

import numpy as np
import torch

from phlash_tpu_torch.size_history import DemographicModel

QUANTILES = (0.025, 0.5, 0.975)


def _posterior_quantiles(batched_dms: DemographicModel, t: torch.Tensor) -> torch.Tensor:
    """(3, len(t)): the 2.5%, 50% and 97.5% quantiles of Ne(t) over the
    particles of a batched model (eta leaves (P, M))."""
    Ne = batched_dms.eta(t, Ne=True)
    return torch.quantile(Ne, torch.tensor(QUANTILES, dtype=Ne.dtype, device=Ne.device), dim=0)


def _in_notebook() -> bool:
    try:
        from IPython import get_ipython

        shell = get_ipython()
        return shell is not None and "IPKernelApp" in shell.config
    except Exception:
        return False


def liveplot_cb(truth: DemographicModel = None, num_points: int = 200):
    """Return a callback(dms_batched) that live-updates a posterior plot.

    Raises ImportError when no live-plot backend is available, which `fit`
    treats as "use no callback".
    """
    if not _in_notebook():
        raise ImportError("live plotting requires a Jupyter environment")
    import plotly.graph_objects as go  # optional dependency
    from IPython.display import display

    fig = go.FigureWidget()
    fig.update_xaxes(type="log", title="Time")
    fig.update_yaxes(type="log", title="Ne")
    if truth is not None:
        tt = np.geomspace(max(float(truth.eta.t[1]), 1e-6), float(truth.eta.t[-1]) * 2, 200)
        fig.add_scatter(x=tt, y=truth.eta(torch.from_numpy(tt), Ne=True).cpu().numpy(),
                        name="truth")
    lower = fig.add_scatter(x=[], y=[], line=dict(width=0), showlegend=False).data[-1]
    upper = fig.add_scatter(
        x=[], y=[], fill="tonexty", line=dict(width=0), name="95% band"
    ).data[-1]
    median = fig.add_scatter(x=[], y=[], name="median").data[-1]
    display(fig)

    def cb(dms_batched: DemographicModel):
        t1 = float(torch.quantile(dms_batched.eta.t[:, 1], 0.025))
        tM = float(torch.quantile(dms_batched.eta.t[:, -1], 0.975))
        t = np.geomspace(max(t1, 1e-8), tM, num_points)
        lo, med, hi = _posterior_quantiles(dms_batched, torch.from_numpy(t)).cpu().numpy()
        with fig.batch_update():
            for trace, y in [(lower, lo), (upper, hi), (median, med)]:
                trace.x = t
                trace.y = y

    return cb
