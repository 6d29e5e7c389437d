"""The port's published-catalog tiers on the CPU against phlash_tpu.sim.

The counterpart of tests/test_sim.py:56-301, case by case, with the same
fake modules and fake `scrm` scripts (imported from that file): the scrm
stream parser, the scrm subprocess end to end, the command line, and
stdpopsim_dataset's engine switch, scrm fallback and forced engine; plus
compute_truth and compute_truth_msprime.  demes, msprime, stdpopsim and
scrm are absent here and on the card's host.  Where both packages run, the
port's output equals phlash_tpu's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_sim import (  # noqa: E402
    _SCRM_BODY,
    _canned_scrm,
    _FakeDebugger,
    _fake_stdpopsim_pair,
    _install_fake_demes,
    _install_fake_stdpopsim,
    _write_fake_scrm,
)

from phlash_tpu import sim as jsim  # noqa: E402
from phlash_tpu_torch import sim  # noqa: E402
from phlash_tpu_torch.data import RawContig, TreeSequenceContig  # noqa: E402


def _same_contig(ours, theirs):
    np.testing.assert_array_equal(ours.het_matrix, theirs.het_matrix)
    np.testing.assert_array_equal(ours.afs, theirs.afs)
    assert ours.window_size == theirs.window_size


def test_parse_scrm_stream():
    contig = sim.parse_scrm_stream(_canned_scrm(), window_size=100)
    assert isinstance(contig, RawContig) and contig.het_matrix.shape == (2, 10)
    want0, want1 = np.zeros(10, int), np.zeros(10, int)
    want0[0] = want0[1] = 1  # pos 12, 131
    want1[1] = 2  # pos 130 and 131
    np.testing.assert_array_equal(contig.het_matrix[0], want0)
    np.testing.assert_array_equal(contig.het_matrix[1], want1)
    np.testing.assert_array_equal(contig.afs, [1, 1, 1])
    _same_contig(contig, jsim.parse_scrm_stream(_canned_scrm(), window_size=100))


def test_parse_scrm_stream_position_clipping():
    "A site exactly at L lands in the final window."
    lines = _canned_scrm(L=1000, variants=[(1000.0, "0 1 0 0")])
    contig = sim.parse_scrm_stream(lines, window_size=100)
    assert contig.het_matrix[0, 9] == 1
    _same_contig(contig, jsim.parse_scrm_stream(lines, window_size=100))


@pytest.mark.parametrize("lines", [["msprime 4 1"], ["scrm 4 1 -t 1 -r 5 100"],
                                   ["scrm 3 1 -t 1 -r 5 100", "position time"]],
                         ids=["not-scrm", "no-body", "odd-haplotypes"])
def test_parse_scrm_stream_rejects_garbage(lines):
    with pytest.raises(ValueError):
        sim.parse_scrm_stream(lines, window_size=100)


def test_scrm_threshold_constant():
    assert sim.SCRM_RHO_THRESHOLD == jsim.SCRM_RHO_THRESHOLD == 1e5


def test_simulate_scrm_subprocess_end_to_end(tmp_path, monkeypatch):
    calls = _install_fake_demes(monkeypatch)
    monkeypatch.setenv("SCRM_PATH", str(_write_fake_scrm(tmp_path, _SCRM_BODY)))
    model, chrom = _fake_stdpopsim_pair(L=1000)
    contig = sim.simulate_scrm(model, chrom, {"pop0": 1}, N0=1e4, seed=7)
    assert calls == [{"graph": model.model.to_demes(), "N0": 1e4, "samples": [2]}]
    want = np.zeros(10, int)
    want[0] = want[9] = 1
    np.testing.assert_array_equal(contig.het_matrix, want[None])
    np.testing.assert_array_equal(contig.afs, [2])
    _same_contig(contig, jsim.simulate_scrm(model, chrom, {"pop0": 1}, N0=1e4, seed=7))


def test_simulate_scrm_nonzero_exit_raises(tmp_path, monkeypatch):
    _install_fake_demes(monkeypatch)
    monkeypatch.setenv("SCRM_PATH", str(_write_fake_scrm(tmp_path, _SCRM_BODY, exit_code=3)))
    model, chrom = _fake_stdpopsim_pair(L=1000)
    with pytest.raises(RuntimeError, match="status 3"):
        sim.simulate_scrm(model, chrom, {"pop0": 1}, N0=1e4, seed=7)


def test_build_scrm_command_windowed_approximation(monkeypatch):
    _install_fake_demes(monkeypatch, ms_flags="-eN 0.5 2.0")
    graph = object()
    kw = dict(N0=1e4, theta=0.4, rho=0.4, L=1000, seed=1)
    argv = sim.build_scrm_command(graph, [300], **kw)
    assert argv[1:3] == ["300", "1"]
    assert "-eN" in argv and "--transpose-segsites" in argv
    assert argv[argv.index("-l") + 1] == "100r"
    assert "-l" not in sim.build_scrm_command(graph, [2], **kw)
    assert argv == jsim.build_scrm_command(graph, [300], **kw)


def test_mean_coal_N0():
    from types import SimpleNamespace

    model = SimpleNamespace(model=SimpleNamespace(debug=_FakeDebugger))
    assert sim.mean_coal_N0(model, ["pop0"]) == jsim.mean_coal_N0(model, ["pop0"]) == 1e4


def test_stdpopsim_dataset_engine_switch(tmp_path, monkeypatch):
    """Chromosome 1 (4 N0 r L = 1.2e5 > 1e5) through scrm, chromosome 2 (4e3)
    through msprime; X, haploid and non-recombining ids filtered."""
    _FakeDebugger.mean_coal_calls = 0
    _install_fake_demes(monkeypatch)
    monkeypatch.setenv("SCRM_PATH", str(_write_fake_scrm(tmp_path, _SCRM_BODY)))
    _, sim_log = _install_fake_stdpopsim(monkeypatch, {"1": 3_000_000, "2": 100_000})
    out = sim.stdpopsim_dataset("FakeSap", "SomeModel_1X00", {"pop0": 1}, seed=5)
    assert set(out["data"]) == {"1", "2"}
    assert isinstance(out["data"]["1"], RawContig)
    assert isinstance(out["data"]["2"], TreeSequenceContig)
    assert sim_log == [(100_000, 6)]  # seed + chromosome index
    assert _FakeDebugger.mean_coal_calls == 1
    truth = out["truth"]
    assert truth.theta == 1.3e-8 and truth.rho is None
    assert truth.eta.c.dtype == torch.float64
    np.testing.assert_allclose(truth.eta.c.numpy(), 5e-5)
    ours = {k: c.get_data(window_size=100) for k, c in out["data"].items()}
    theirs = jsim.stdpopsim_dataset("FakeSap", "SomeModel_1X00", {"pop0": 1}, seed=5)
    for k, c in theirs["data"].items():
        want = c.get_data(window_size=100)
        np.testing.assert_array_equal(ours[k]["het_matrix"], want["het_matrix"])
        np.testing.assert_array_equal(ours[k]["afs"], want["afs"])
    np.testing.assert_allclose(truth.eta.t.numpy(), np.asarray(theirs["truth"].eta.t))


def test_stdpopsim_dataset_scrm_failure_falls_back(tmp_path, monkeypatch, caplog):
    _install_fake_demes(monkeypatch)
    monkeypatch.setenv("SCRM_PATH", str(_write_fake_scrm(tmp_path, ["not a transpose stream"])))
    _, sim_log = _install_fake_stdpopsim(monkeypatch, {"1": 3_000_000})
    with caplog.at_level("WARNING", logger="phlash_tpu_torch.sim"):
        out = sim.stdpopsim_dataset("FakeSap", "SomeModel_1X00", {"pop0": 1}, seed=5)
    assert isinstance(out["data"]["1"], TreeSequenceContig)
    assert sim_log == [(3_000_000, 5)]
    assert any("using msprime" in r.message for r in caplog.records)


def test_stdpopsim_dataset_forced_engine(monkeypatch):
    "options={'engine': 'msprime'} skips the N0 computation."
    _FakeDebugger.mean_coal_calls = 0
    _, sim_log = _install_fake_stdpopsim(monkeypatch, {"1": 3_000_000})
    out = sim.stdpopsim_dataset("FakeSap", "SomeModel_1X00", {"pop0": 1}, seed=5,
                                options={"engine": "msprime"})
    assert _FakeDebugger.mean_coal_calls == 0
    assert sim_log == [(3_000_000, 5)]
    assert set(out["data"]) == {"1"}


def test_compute_truth_msprime():
    "The trajectory on 1000 geometric times from t_min to max(1e5, last epoch + 1)."
    from types import SimpleNamespace

    demo = SimpleNamespace(debug=_FakeDebugger)
    eta = sim.compute_truth_msprime(demo, ["pop0"])
    want = jsim.compute_truth_msprime(demo, ["pop0"])
    np.testing.assert_allclose(eta.t.numpy(), np.asarray(want.t), rtol=1e-15)
    np.testing.assert_allclose(eta.c.numpy(), np.asarray(want.c))


@pytest.mark.parametrize("preset", ["bottleneck_demography", "zigzag_demography"])
def test_compute_truth(preset):
    "compute_truth on its default grid and a given one equals phlash_tpu's (float64)."
    dm, jdm = getattr(sim, preset)(), getattr(jsim, preset)()
    for grid in (None, np.geomspace(1e-3, 30.0, 50)):
        eta, want = sim.compute_truth(dm, grid), jsim.compute_truth(jdm, grid)
        np.testing.assert_allclose(eta.t.numpy(), np.asarray(want.t), rtol=1e-15)
        np.testing.assert_allclose(eta.c.numpy(), np.asarray(want.c), rtol=1e-12)
