"""SizeHistory.to_demes / from_demography / draw of the port against phlash_tpu.

The counterpart of tests/test_size_history.py:130-200 with the same
stand-ins for demes and msprime (absent here and on the card's host), and
`draw` against phlash_tpu's on fresh Agg axes: the same line and scatter
data, scales and labels.
"""

import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from phlash_tpu.size_history import SizeHistory as JaxSizeHistory  # noqa: E402
from phlash_tpu_torch.size_history import SizeHistory  # noqa: E402

T, C = np.array([0.0, 1.0, 3.0]), np.array([0.5, 2.0, 1.0])


def _ours(t=T, c=C):
    return SizeHistory(t=torch.as_tensor(t, dtype=torch.float64),
                       c=torch.as_tensor(c, dtype=torch.float64))


def _fake_demes(monkeypatch):
    fake = types.ModuleType("demes")

    class Builder:
        def __init__(self):
            self.demes = []

        def add_deme(self, name, epochs):
            self.demes.append((name, epochs))

        def resolve(self):
            return self

    fake.Builder = Builder
    monkeypatch.setitem(sys.modules, "demes", fake)


def test_to_demes_epoch_layout(monkeypatch):
    """Epochs oldest first with decreasing end times, each at the constant
    size of its interval: phlash_tpu's graph."""
    _fake_demes(monkeypatch)
    ((name, epochs),) = _ours().to_demes("pop").demes
    assert name == "pop"
    assert [e["end_time"] for e in epochs] == [3.0, 1.0, 0.0]
    np.testing.assert_allclose([e["start_size"] for e in epochs], (0.5 / C)[::-1])
    assert all(e["end_size"] == e["start_size"] and e["size_function"] == "constant"
               for e in epochs)
    assert epochs == JaxSizeHistory(t=T, c=C).to_demes("pop").demes[0][1]


def _fake_msprime(monkeypatch):
    fake = types.ModuleType("msprime")

    class Demography:
        pass

    fake.Demography = Demography
    monkeypatch.setitem(sys.modules, "msprime", fake)

    class _Dbg:
        epoch_start_time = np.array([0.0, 2.0, 5.0])

        def population_size_trajectory(self, steps):
            Ne = np.where(steps < 2, 100.0, np.where(steps < 5, 300.0, 200.0))
            return Ne[:, None]

    def demography(n_pops):
        demo = Demography()
        demo.num_populations = n_pops
        demo.debug = _Dbg
        return demo

    return demography


def test_from_demography_piecewise_extraction(monkeypatch):
    "Only the change points of the size trajectory survive; several populations raise."
    demography = _fake_msprime(monkeypatch)
    eta = SizeHistory.from_demography(demography(1))
    assert eta.t.dtype == torch.float64
    np.testing.assert_array_equal(eta.t.numpy(), [0.0, 2.0, 5.0])
    np.testing.assert_allclose(eta.c.numpy(), 1.0 / (2.0 * np.array([100.0, 300.0, 200.0])))
    want = JaxSizeHistory.from_demography(demography(1))
    np.testing.assert_array_equal(eta.t.numpy(), np.asarray(want.t))
    np.testing.assert_array_equal(eta.c.numpy(), np.asarray(want.c))
    with pytest.raises(ValueError, match="single-population"):
        SizeHistory.from_demography(demography(2))


def _drawn(eta, **kw):
    "(line xy data, scatter offsets, scales, labels) of eta.draw on a fresh Agg axis."
    fig, ax = plt.subplots()
    try:
        eta.draw(ax=ax, **kw)
        return ([ln.get_xydata() for ln in ax.lines], [c.get_offsets() for c in ax.collections],
                (ax.get_xscale(), ax.get_yscale()), (ax.get_xlabel(), ax.get_ylabel()),
                [ln.get_drawstyle() for ln in ax.lines])
    finally:
        plt.close(fig)


@pytest.mark.parametrize("kw", [{}, dict(density=True), dict(density=True, c=3.0),
                                dict(color="k", label="truth")],
                         ids=["Ne", "density", "density-c3", "kwargs"])
def test_draw_matches_jax(kw):
    "draw plots the data phlash_tpu's draw plots: Ne(t) steps and its last point, or the density."
    t = np.r_[0.0, np.geomspace(1e-3, 15.0, 15)]
    c = np.exp(np.sin(np.linspace(0.0, 3.0 * np.pi, 16)))
    ours, theirs = _drawn(_ours(t, c), **kw), _drawn(JaxSizeHistory(t=t, c=c), **kw)
    assert len(ours[0]) == len(theirs[0]) == 1
    np.testing.assert_allclose(ours[0][0], theirs[0][0], rtol=1e-12)
    assert len(ours[1]) == len(theirs[1])
    for a, b in zip(ours[1], theirs[1]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)
    assert ours[2:] == theirs[2:]


def test_draw_on_the_current_axis_and_one_model_only():
    "Without ax it draws on plt.gca(); a batch of histories is refused."
    fig = plt.figure()
    try:
        _ours().draw()
        assert len(plt.gca().lines) == 1
    finally:
        plt.close(fig)
    batched = SizeHistory(t=torch.zeros(2, 3), c=torch.ones(2, 3))
    with pytest.raises(ValueError, match="one model"):
        batched.draw()
