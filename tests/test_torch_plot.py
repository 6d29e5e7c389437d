"""plot_posterior and the live plot of phlash_tpu_torch against phlash_tpu's
on the same models (carried across by convert.py): the median and band that
plot_posterior returns, the live plot's quantiles, its notebook-only
refusal, and fit's default callback."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import sys
import types
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

import phlash_tpu_torch
from phlash_tpu.liveplot import _posterior_quantiles as jax_quantiles
from phlash_tpu.size_history import DemographicModel as JaxDM
from phlash_tpu.size_history import SizeHistory as JaxSH
from phlash_tpu_torch import convert
from phlash_tpu_torch.data import RawContig
from phlash_tpu_torch.liveplot import _posterior_quantiles, liveplot_cb
from phlash_tpu_torch.size_history import DemographicModel, SizeHistory


def _jax_models(n=40, M=16, seed=0):
    "n models of random breakpoints and rates, float64, as phlash_tpu's."
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = np.r_[0.0, np.sort(rng.uniform(1e-3, 12.0, M - 1))]
        out.append(JaxDM(eta=JaxSH(t=jnp.asarray(t), c=jnp.asarray(rng.lognormal(0, 0.5, M))),
                         theta=1e-2, rho=float(rng.uniform(5e-3, 2e-2))))
    return out


def _batched(models):
    "The port's batched model (leaves (P, M)), as fit hands it to a callback."
    eta = SizeHistory(t=torch.stack([m.eta.t for m in models]),
                      c=torch.stack([m.eta.c for m in models]))
    return DemographicModel(eta=eta, theta=models[0].theta,
                            rho=torch.stack([torch.as_tensor(m.rho) for m in models]))


@pytest.mark.parametrize("credible_width", [0.95, 0.5, None])
def test_plot_posterior_matches_jax(credible_width):
    """(t, median, band) equal phlash_tpu.plot.plot_posterior's on the same
    models, drawn on Agg axes."""
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    from phlash_tpu.plot import plot_posterior as jax_plot

    theirs_in = _jax_models()
    ours_in = [convert.from_reference_dm(m) for m in theirs_in]
    fig, (a, b) = plt.subplots(1, 2)
    t, med, band = phlash_tpu_torch.plot_posterior(ours_in, ax=a, credible_width=credible_width)
    jt, jmed, jband = jax_plot(theirs_in, ax=b, credible_width=credible_width)
    plt.close(fig)
    np.testing.assert_allclose(t, jt, rtol=1e-14)
    np.testing.assert_allclose(med, jmed, rtol=1e-12)
    assert (band is None) == (jband is None) == (credible_width is None)
    for x, y in zip(band or (), jband or ()):
        np.testing.assert_allclose(x, y, rtol=1e-12)
    assert a.get_xscale() == a.get_yscale() == "log" and len(a.lines) == 1


def test_plot_posterior_default_axis():
    "Without an axis, plot_posterior draws on matplotlib's current one."
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    t, med, band = phlash_tpu_torch.plot_posterior(
        [convert.from_reference_dm(m) for m in _jax_models(8)], generations=False)
    assert plt.gca().get_xlabel() == "Time" and len(plt.gca().lines) == 1
    assert t.shape == med.shape == band[0].shape == (200,)
    plt.close(fig)


def test_posterior_quantiles_match_jax():
    "The live plot's 2.5/50/97.5% quantiles of Ne(t) equal phlash_tpu's."
    theirs = _jax_models(33, seed=1)
    batched = jax.tree.map(lambda *x: jnp.stack(x), *theirs)
    t = np.geomspace(1e-3, 20.0, 50)
    want = np.asarray(jax_quantiles(batched, jnp.asarray(t)))
    got = _posterior_quantiles(_batched([convert.from_reference_dm(m) for m in theirs]),
                               torch.from_numpy(t))
    assert got.shape == (3, 50)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("ipython", ["no-shell", "absent"])
def test_liveplot_requires_a_notebook(monkeypatch, ipython):
    "Outside Jupyter liveplot_cb raises ImportError, which fit takes as no callback."
    mod = None
    if ipython == "no-shell":
        mod = types.ModuleType("IPython")
        mod.get_ipython = lambda: None
    monkeypatch.setitem(sys.modules, "IPython", mod)
    with pytest.raises(ImportError):
        liveplot_cb()


class _FakeTrace:
    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.x, self.y = kw.get("x"), kw.get("y")


class _FakeFigureWidget:
    "The members of plotly's FigureWidget that liveplot_cb uses."

    def __init__(self):
        self.data = []

    def update_xaxes(self, **kw):
        pass

    def update_yaxes(self, **kw):
        pass

    def add_scatter(self, **kw):
        self.data.append(_FakeTrace(**kw))
        return self

    def batch_update(self):
        import contextlib

        return contextlib.nullcontext()


def _install_notebook(monkeypatch) -> list:
    "A fake Jupyter shell and plotly; returns the list of displayed figures."
    ipython = types.ModuleType("IPython")
    ipython.get_ipython = lambda: SimpleNamespace(config={"IPKernelApp": {}})
    display_mod = types.ModuleType("IPython.display")
    shown = []
    display_mod.display = shown.append
    ipython.display = display_mod
    plotly = types.ModuleType("plotly")
    go = types.ModuleType("plotly.graph_objects")
    go.FigureWidget = _FakeFigureWidget
    plotly.graph_objects = go
    for name, mod in [("IPython", ipython), ("IPython.display", display_mod),
                      ("plotly", plotly), ("plotly.graph_objects", go)]:
        monkeypatch.setitem(sys.modules, name, mod)
    return shown


def test_liveplot_updates_traces(monkeypatch):
    """In a notebook: a truth trace and the band / median traces; identical
    particles collapse the band onto the median, Ne = 1 / (2c)."""
    shown = _install_notebook(monkeypatch)
    unit = DemographicModel(eta=SizeHistory(t=torch.tensor([0.0, *np.geomspace(1e-3, 10.0, 7)]),
                                            c=torch.ones(8)), theta=1e-2, rho=1e-2)
    cb = liveplot_cb(truth=unit, num_points=16)
    (fig,) = shown
    assert len(fig.data) == 4
    cb(_batched([unit] * 4))
    lower, upper, median = fig.data[1:]
    for tr in (lower, upper, median):
        assert len(tr.x) == len(tr.y) == 16
    np.testing.assert_allclose(lower.y, median.y, rtol=1e-6)
    np.testing.assert_allclose(median.y, 0.5, rtol=1e-6)


def test_fit_defaults_to_the_live_plot(monkeypatch):
    "fit without a callback, in a notebook, updates the live plot after each call."
    shown = _install_notebook(monkeypatch)
    rng = np.random.default_rng(0)
    het = (rng.random((1, 3000)) < 0.05).astype(np.int8)
    models = phlash_tpu_torch.fit([RawContig(het, np.ones(1), 100)], device="cpu", niter=2,
                                  num_particles=4, overlap=20, chunk_size=200, progress=False)
    assert len(models) == 4
    (fig,) = shown
    median = fig.data[-1]
    assert len(median.x) == 200 and np.isfinite(median.y).all()
