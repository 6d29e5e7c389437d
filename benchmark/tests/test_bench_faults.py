"""The check fails a run whose timed path is broken underneath.

Each case drives the rest of a run on the CPU (the plain versions stand in
for the kernels; the harness's look for a card is skipped) with one fault
planted in the program, and sees `correct` come out false.  The faults a
one-chip training cell can have: a step that returns its state unchanged;
half of the batch left out, the mean taken over the rest; an answer
altered where it is produced (the likelihood reads the body of each
minibatch chunk's successor).  benchmark/readings.py plants the same
faults in the reference at the cells' own size.  The cell's own limits
hold: at this size the sound run reads about a thousandth of them."""

import pytest
import torch

import phlash_tpu_torch.svgd as port_svgd
import phlash_tpu_torch.training as training
from benchmark import run


def unchanged(monkeypatch):
    monkeypatch.setattr(port_svgd.SVGD, "step", lambda self, state, **kw: state)


def half(monkeypatch):
    def direction(x, g, rows=slice(None)):
        n = x.shape[0] // 2
        sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        h = port_svgd.median_bandwidth(sq, x.shape[0])
        K = torch.exp(-sq[:, :n] / h)
        return (K @ g[:n] - (2.0 / h) * (K @ x[:n] - K.sum(1, keepdim=True) * x)) / n

    monkeypatch.setattr(port_svgd, "svgd_direction", direction)


def altered(monkeypatch):
    density = training.log_density_batched

    def shifted(mcps, c, inds, warmup, kern, afs, afs_transform=None):
        body = kern.data[(inds + 1) % kern.data.shape[0]]
        return density(mcps, c, inds, warmup, _Rows(kern, body), afs, afs_transform)

    monkeypatch.setattr(training, "log_density_batched", shifted)


class _Rows:
    "A kernel whose rows at `inds` are `body` (the successors'), and otherwise the kernel."

    def __init__(self, kern, body):
        self.kern, self.body = kern, body

    @property
    def data(self):
        return _Index(self.body)

    def __getattr__(self, name):
        return getattr(self.kern, name)


class _Index:
    def __init__(self, body):
        self.body = body

    def __getitem__(self, inds):
        return self.body


@pytest.mark.parametrize("fault", [None, unchanged, half, altered],
                         ids=["sound", "unchanged", "half", "altered"])
def test_fault_fails_the_check(tiny, monkeypatch, fault):
    cell = tiny("diploid.genome", particles=8)
    if fault is not None:
        fault(monkeypatch)
    out = run.run_cell(cell, 20240613, 3.0, False, device="cpu")
    gap = {k: c["value"] for k, c in out["checks"].items()}
    if fault is None:
        assert out["correct"] and gap["launch_mismatch"] == 0, gap
    else:
        assert not out["correct"], gap
        assert any(gap[k] > v for k, v in cell.limits.items()), gap
