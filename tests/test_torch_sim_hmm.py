"""The port's discretized-HMM simulator on the CPU against phlash_tpu.sim.

The counterpart of tests/test_sim.py:16-78 (shapes, missing data, the het
rate, the true model scoring higher), plus: the HMM it draws from equals
phlash_tpu's at float64; the composition scan equals the sequential chain;
a path agrees with its law (het rate within 4 standard errors, state
marginal and transition counts by chi-square); and the port's het rate and
mean run length agree with phlash_tpu.simulate_hmm's at L = 200,000.  The
draws differ from JAX's (another generator), so the laws are compared, not
the sequences.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from phlash_tpu import sim as jsim  # noqa: E402
from phlash_tpu.params import PSMCParams as JaxPSMCParams  # noqa: E402
from phlash_tpu.transition import transition_matrix as jax_transition_matrix  # noqa: E402
from phlash_tpu_torch import sim  # noqa: E402
from phlash_tpu_torch.hmm import psmc_ll  # noqa: E402
from phlash_tpu_torch.params import PSMCParams  # noqa: E402

PRESETS = ("constant_demography", "zigzag_demography", "bottleneck_demography")


def _path(dm, L, seed):
    "(states, obs, A, emis1) of one simulated path, numpy."
    A, pi, e1 = sim.hmm_arrays(dm)
    s, o = sim.simulate_path(A, pi, e1, L, torch.Generator().manual_seed(seed))
    return s.numpy(), o.numpy(), A.numpy(), e1.numpy()


@pytest.mark.parametrize("preset", PRESETS)
def test_hmm_arrays_match_jax(preset):
    """A (clipped to [1e-20, 1], rows renormalized), pi and emis1 equal
    phlash_tpu.sim.simulate_hmm's at float64 within 1e-12."""
    jdm = getattr(jsim, preset)()
    jA = jax_transition_matrix(jdm).clip(1e-20, 1.0)
    jA = np.asarray(jA / jA.sum(1, keepdims=True))
    jpp = JaxPSMCParams.from_dm(jdm)
    A, pi, e1 = sim.hmm_arrays(getattr(sim, preset)())
    assert A.dtype == torch.float64
    np.testing.assert_allclose(A.numpy(), jA, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(pi.numpy(), np.asarray(jpp.pi), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(e1.numpy(), np.asarray(jpp.emis1), rtol=1e-12)


def test_scan_equals_sequential_chain():
    """The composition scan gives the chain that draws each state from the
    previous one, window by window, with the same uniforms."""
    dm = sim.bottleneck_demography()
    A, pi, e1 = sim.hmm_arrays(dm)
    L, M = 3000, A.shape[0]
    states, obs = sim.simulate_path(A, pi, e1, L, torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    u0, u, v = (torch.rand((n,), generator=g, dtype=torch.float64).numpy() for n in (1, L, L))
    C = torch.cumsum(A, 1).numpy()
    s = min(int(np.searchsorted(np.cumsum(pi.numpy()), u0[0], side="right")), M - 1)
    want = []
    for t in range(L):
        s = min(int(np.searchsorted(C[s], u[t], side="right")), M - 1)
        want.append(s)
    np.testing.assert_array_equal(states.numpy(), want)
    np.testing.assert_array_equal(obs.numpy(), (v < e1.numpy()[want]).astype(np.int8))


def test_simulate_shapes():
    c = sim.simulate_hmm(sim.constant_demography(), L=5000, seed=0, device="cpu")
    assert c.het_matrix.shape == (1, 5000) and c.het_matrix.dtype == np.int8
    assert set(np.unique(c.het_matrix)) <= {0, 1}
    assert c.window_size == 100 and c.afs.tolist() == [1.0]


def test_simulate_missing():
    """missing_frac masks that share of windows to -1, from a stream of its
    own: the other windows are the unmasked sequence's."""
    dm = sim.constant_demography()
    c = sim.simulate_hmm(dm, L=5000, seed=0, missing_frac=0.3, device="cpu")
    full = sim.simulate_hmm(dm, L=5000, seed=0, device="cpu")
    miss = c.het_matrix == -1
    assert 0.2 < miss.mean() < 0.4
    np.testing.assert_array_equal(c.het_matrix[~miss], full.het_matrix[~miss])


@pytest.mark.parametrize("theta", [5e-3, 2e-2])
def test_het_rate_matches_expectation(theta):
    """The het rate at L = 200,000 within 4 standard errors of
    sum pi' emis1 (pi' the stationary law of A), and within the JAX test's
    50% of sum pi emis1."""
    dm = sim.constant_demography(theta=theta, rho=2e-2)
    states, obs, A, e1 = _path(dm, 200_000, 1)
    st = sim.hmm_path_stats(states, obs, A, e1)
    assert abs(st["het_rate"] - st["het_expected"]) < 4 * st["het_se"], st
    pp = PSMCParams.from_dm(dm)
    expected = float((pp.pi * pp.emis1).sum())
    assert abs(obs.mean() / expected - 1.0) < 0.5


@pytest.mark.parametrize("preset", ["bottleneck_demography", "zigzag_demography"])
def test_marginal_and_transitions_chi2(preset):
    """The state marginal against pi' and the transition counts against A,
    by chi-square at L = 200,000: p > 1e-3."""
    states, obs, A, e1 = _path(getattr(sim, preset)(), 200_000, 3)
    st = sim.hmm_path_stats(states, obs, A, e1)
    assert st["marginal_cells"] >= 3 and st["transition_df"] >= 10
    assert st["marginal_p"] > 1e-3 and st["transition_p"] > 1e-3, st


def test_path_stats_reject_a_wrong_law():
    """The same statistics reject a path drawn from another model's HMM:
    the transition counts of the zigzag's path against the bottleneck's A."""
    states, obs, _, e1 = _path(sim.zigzag_demography(), 200_000, 3)
    A, _, _ = sim.hmm_arrays(sim.bottleneck_demography())
    assert sim.hmm_path_stats(states, obs, A.numpy(), e1)["transition_p"] < 1e-6


def test_true_model_scores_higher():
    "The generating model out-scores a wrong one on its sequence (tests/test_sim.py:43-51)."
    truth, wrong = sim.bottleneck_demography(theta=1e-2), sim.zigzag_demography(theta=1e-2)
    obs = torch.as_tensor(sim.simulate_hmm(truth, L=20_000, seed=2, device="cpu").het_matrix[0])
    ll_true = float(psmc_ll(PSMCParams.from_dm(truth), obs)[1])
    ll_wrong = float(psmc_ll(PSMCParams.from_dm(wrong), obs)[1])
    assert ll_true > ll_wrong


def _run_lengths(obs: np.ndarray) -> np.ndarray:
    "Lengths of the maximal runs of equal consecutive values."
    edges = np.flatnonzero(np.diff(obs)) + 1
    return np.diff(np.r_[0, edges, len(obs)])


def _batch_se(obs: np.ndarray, stat, batches: int = 20) -> float:
    "Standard error of stat(obs) by batch means."
    vals = np.array([stat(b) for b in np.array_split(obs, batches)])
    return float(vals.std(ddof=1) / np.sqrt(batches))


def test_het_rate_and_run_length_match_jax():
    """At L = 200,000 under the bottleneck: the port's het rate and mean run
    length against phlash_tpu.simulate_hmm's, within 4 standard errors of
    their difference (the het rate's from A's fundamental matrix, the run
    length's by batch means)."""
    L = 200_000
    jobs = jsim.simulate_hmm(jsim.bottleneck_demography(), L=L, key=11).het_matrix[0]
    states, ours, A, e1 = _path(sim.bottleneck_demography(), L, 11)
    se = sim.hmm_path_stats(states, ours, A, e1)["het_se"]  # each sequence's, from A alone
    assert abs(ours.mean() - jobs.mean()) < 4 * np.sqrt(2) * se, (ours.mean(), jobs.mean(), se)

    def mean_run(x):
        return _run_lengths(x).mean()

    se_run = np.hypot(_batch_se(ours, mean_run), _batch_se(jobs, mean_run))
    assert abs(mean_run(ours) - mean_run(jobs)) < 4 * se_run


def test_simulate_dataset_streams():
    """simulate_dataset draws n_contigs + 1 contigs from independent streams
    of one seed: reproducible, all different; an int seed and a Generator
    both work."""
    dm = sim.constant_demography()
    train, test = sim.simulate_dataset(dm, n_contigs=3, L=4000, seed=5, device="cpu")
    again, test2 = sim.simulate_dataset(dm, n_contigs=3, L=4000, seed=5, device="cpu")
    assert len(train) == 3
    rows = [c.het_matrix[0] for c in (*train, test)]
    for a, b in zip(rows, [c.het_matrix[0] for c in (*again, test2)]):
        np.testing.assert_array_equal(a, b)
    assert all((rows[i] != rows[j]).any() for i in range(4) for j in range(i))
    g = torch.Generator().manual_seed(1)
    c = sim.simulate_hmm(dm, 4000, seed=g, missing_frac=0.1, device="cpu")
    assert c.het_matrix.shape == (1, 4000) and (c.het_matrix == -1).any()


def test_cuda_by_default_without_a_card():
    "The entry point runs on the card unless asked otherwise: no silent CPU fallback."
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.simulate_hmm(sim.constant_demography(), 100)
