"""Each row's live end (ops/smc.py, csrc/smc_common.cuh) on the CPU, float64.

A likelihood that discards the final state runs each row up to the end of
the period that holds its last observed site: past it every emission
factor is 1 and the structured transition is row-stochastic, so the tail
adds log 1 = 0 to ll and nothing to the gradient of the model's
parameters.  Here: the rule that finds the ends; the trimmed plain forward
and adjoint against the whole-row ones (ll, the model's gradients through
PSMCParams.from_dm, the emissions' and pi's own gradients, pstates before
each end bitwise, a row with no tail bitwise); the split's plain rendering
with ends against the trimmed unsplit one, bitwise where the kernels are;
who trims (the fit's density) and who does not (the warm-up filter and
phlash_tpu's entries, which take any PSMCParams).
The kernels' own checks run on the card (chip_smoke.py phase 3e; the
`cuda` tests here)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from phlash_tpu_torch.kernel_base import through_from_dm  # noqa: E402
from phlash_tpu_torch.ops import smc, split  # noqa: E402
from phlash_tpu_torch.ops.kernel_smc import SMCKernel, SMCOp, smc_op  # noqa: E402
from phlash_tpu_torch.params import PSMC_FIELDS, PSMCParams  # noqa: E402
from phlash_tpu_torch.size_history import DemographicModel  # noqa: E402

E = smc.NORM_EVERY
C = smc.CHECK_PERIODS


def _rows(L: int, lasts, seed: int = 3, het: float = 0.1) -> torch.Tensor:
    """int8 rows of L sites at the het rate, each missing (-1) after its
    last observed site (`lasts`; None: no tail, -1: wholly missing)."""
    rng = np.random.default_rng(seed)
    obs = rng.binomial(1, het, size=(len(lasts), L)).astype(np.int8)
    for s, last in enumerate(lasts):
        if last is not None:
            obs[s, last + 1:] = -1
    return torch.as_tensor(obs)


def _dm(rho: float) -> DemographicModel:
    return DemographicModel.default(pattern="16*1", theta=0.1, rho=rho)


def _params(dms):
    """The six per-particle rows (B, M) and pi (B, M) of one model a particle:
    each one's structured transition row-stochastic."""
    pps = [PSMCParams.from_dm(dm) for dm in dms]
    rows = [torch.stack([getattr(pp, k) for pp in pps]).contiguous() for k in PSMC_FIELDS]
    return rows[:6], rows[6]


@pytest.mark.parametrize("L,lasts,want", [
    (160, (None, 37, 40, -1, 0, 7, 8), (20, 5, 6, 0, 1, 1, 2)),
    (45, (None, 43, 39), (6, 6, 5)),
])
def test_live_periods_is_the_period_of_the_last_observed_site(L, lasts, want):
    """n_live = last // NORM_EVERY + 1 (the period past the row's last 0 / 1),
    0 on a row with none, every period (a partial last one too) on a row
    with no tail; missing (-1) and padding (-2) are not observed."""
    obs = _rows(L, lasts)
    assert smc.live_periods(obs).tolist() == list(want)
    obs[0, L - 3:] = -2  # a padded end
    got = smc.live_periods(obs)
    assert got.dtype == torch.int32 and int(got[0]) == (L - 4) // E + 1


# (L, each row's last observed site): the end mid-period, on a period, on a
# checkpoint interval (16 periods) and on a segment of 32 periods; a wholly
# missing row (beside one with no tail, whose ll and gradients set the
# scale); a row with no tail; S = 4 rows with four different ends.
TRIM_CASES = {
    "mid_period": (400, (237,)),
    "on_a_checkpoint": (600, (C * E - 1,)),
    "on_a_segment": (900, (2 * C * E - 1,)),
    "wholly_missing": (200, (-1, None)),
    "no_tail": (203, (None,)),
    "different_ends": (400, (None, 300, -1, 2 * C * E - 1)),
}


def _trim_case(case, B: int = 2):
    "(models, the six rows, pi (B, M), pi (B, S, M), rows) of a TRIM_CASES case."
    L, lasts = TRIM_CASES[case]
    dms = [_dm(r) for r in (0.05, 0.1, 0.2)[:B]]
    params, pi_rows = _params(dms)
    obs = _rows(L, lasts)
    pi = pi_rows[:, None, :].expand(B, len(lasts), -1).contiguous()
    return dms, params, pi_rows, pi, obs


@pytest.mark.parametrize("case", sorted(TRIM_CASES))
def test_the_trimmed_plain_versions_are_the_whole_rows(case):
    """Each row to its live end against the whole row: ll to 1e-12 (of the
    largest |ll| where a row holds no observed site), the states before each
    end bitwise, pstates zero from it; the emissions' gradients and dpi (on
    rows with an observed site) to 1e-10 of their largest; each chunk's
    gradient of the model (t, c, theta, rho, through PSMCParams.from_dm) to
    1e-10 of the largest entry over the chunks; a row with no tail bitwise
    whole."""
    dms, params, _, pi, obs = _trim_case(case)
    B, S, M = pi.shape
    live = smc.live_periods(obs)
    n_per = smc.n_periods(obs.shape[1])
    ll, alpha, pst = smc.forward_structured(params, pi, obs, True)
    ll_t, alpha_t, pst_t = smc.forward_structured(params, pi, obs, True, live)
    scale = float(ll.abs().max())
    np.testing.assert_allclose(ll_t.numpy(), ll.numpy(), rtol=1e-12, atol=1e-12 * scale)
    for s in range(S):
        n = int(live[s])
        assert torch.equal(pst_t[:n, s], pst[:n, s]) and not pst_t[n:, s].any()
        if n == n_per:  # no tail: the whole row's bits
            assert torch.equal(ll_t[:, s], ll[:, s]) and torch.equal(alpha_t[:, s], alpha[:, s])
    gbar = torch.linspace(0.5, 1.5, B * S, dtype=torch.float64).view(B, S)
    zero = torch.zeros_like(pi)
    grads, dpi = smc.backward_structured(params, obs, pst, gbar, zero)
    grads_t, dpi_t = smc.backward_structured(params, obs, pst_t, gbar, zero, live)
    seen = live > 0
    for name, a, b in (("emis0", grads_t[4], grads[4]), ("emis1", grads_t[5], grads[5]),
                       ("pi", dpi_t[:, seen], dpi[:, seen])):
        err = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-300)
        assert err <= 1e-10, (name, err)
    assert torch.equal(dpi_t[:, ~seen], zero[:, ~seen])  # no live period: dpi = abar0
    for s in range(S):
        if int(live[s]) == n_per:
            for a, b in zip((*grads_t, dpi_t), (*grads, dpi)):
                assert torch.equal(a[:, s], b[:, s])
    for p, dm in enumerate(dms):  # the model's gradient, chunk by chunk
        full, trim = (through_from_dm(dm, PSMCParams(*(x[p] for x in g)))
                      for g in ((*grads, dpi), (*grads_t, dpi_t)))
        a, b = (torch.cat([m.eta.t, m.eta.c, m.theta[:, None], m.rho[:, None]], 1)
                for m in (trim, full))
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= 1e-10, (p, err)


def test_a_tail_moves_the_state_the_filter_reads():
    """What the trim leaves out does move the final state (so the warm-up
    filter, which reads it, keeps whole rows), while ll stays."""
    _, params, _, pi, obs = _trim_case("mid_period")
    live = smc.live_periods(obs)
    ll, alpha, _ = smc.forward_structured(params, pi, obs, False)
    ll_t, alpha_t, _ = smc.forward_structured(params, pi, obs, False, live)
    assert not torch.allclose(alpha_t, alpha, rtol=1e-3)
    np.testing.assert_allclose(ll_t.numpy(), ll.numpy(), rtol=1e-12)


def test_the_filter_keeps_whole_rows_and_the_likelihood_trims(monkeypatch):
    """SMCKernel.filter_batched's alpha is the whole-row forward's, bitwise,
    on a prefix with a missing tail; the fit's density (model_loglik_rows,
    through model.log_density_rows) finds the live ends of the rows it gets,
    while the filter and the phlash_tpu entries (loglik_rows, instance_grads,
    whose PSMCParams need not come from a model) never do."""
    from phlash_tpu_torch.model import log_density_rows
    from phlash_tpu_torch.params import MCMCParams

    dms, params, pi_rows, _, _ = _trim_case("mid_period")
    warmup = _rows(64, (None, 40, -1), seed=5)
    pp = PSMCParams(*params, pi=pi_rows)
    kern = SMCKernel(16, np.zeros((2, 64), np.int8), device="cpu")
    calls = []
    real = smc.live_periods
    monkeypatch.setattr(smc, "live_periods", lambda obs, B=1: calls.append(obs) or real(obs, B))
    alpha = kern.filter_batched(pp, warmup)
    want = smc.forward_structured(params, pi_rows[:, None].expand(-1, 3, -1), warmup, False)[1]
    assert torch.equal(alpha, want) and calls == []
    kern.loglik_rows(pp.replace(pi=alpha), warmup)
    kern.instance_grads(PSMCParams.from_dm(dms[0]), warmup)
    assert calls == []
    ll = kern.model_loglik_rows(pp.replace(pi=alpha), warmup)
    assert len(calls) == 1 and torch.equal(calls[0], warmup)
    assert torch.equal(ll, smc_op(pp, alpha, warmup, trim=True)[0])
    mcps = MCMCParams.from_linear(pattern="16*1", t1=1e-4, tM=15.0, c=[1.0] * 16, theta=0.1,
                                  rho=0.1)
    mcps = mcps.unflatten(mcps.flatten()[None])
    log_density_rows(mcps, (1.0, 1.0, 1.0), warmup[:, :8], warmup, kern, None)
    assert len(calls) == 3 and torch.equal(calls[2], warmup)  # smc_op above made the second


def test_the_trimmed_op_gradcheck():
    """torch.autograd.gradcheck of SMCOp with trim (both outputs: alpha is
    the state at each row's live end) on rows with a tail, one wholly missing."""
    _, params, _, pi, _ = _trim_case("mid_period")
    obs = _rows(29, (13, None, -1), seed=7)
    pi = pi[:, :1].expand(-1, 3, -1).contiguous()
    leaves = [x[:, :8].clone().requires_grad_(True) for x in params]
    pi8 = (pi[..., :8] / pi[..., :8].sum(-1, keepdim=True)).clone().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda *xs: SMCOp.apply(obs, True, True, *xs),
                                    [*leaves, pi8])


def test_smc_op_trim_is_the_live_end_forward():
    "smc_op with trim: ll and the state at each row's live end of the plain trimmed forward."
    _, params, pi_rows, pi, obs = _trim_case("different_ends")
    pp = PSMCParams(*params, pi=pi_rows)
    ll, alpha = smc_op(pp, pi, obs, trim=True)
    want_ll, want_alpha, _ = smc.forward_structured(params, pi, obs, False,
                                                    smc.live_periods(obs))
    assert torch.equal(ll, want_ll) and torch.equal(alpha, want_alpha)


# The split's plain rendering with ends: (L, each row's last observed site,
# the segments asked for).  K from 2 to past the row's intervals; rows whose
# end leaves segments wholly past it, ends on a segment's first period and on
# its last, a wholly missing row, a row with no tail.
SPLIT_TRIM_CASES = {
    "k2_mid": (1500, (None, 700, 93), 2),
    "k3_ends_on_segments": (3000, (None, 64 * E - 1, 64 * E, 2 * 64 * E + 3), 3),
    "k6_wholly_missing": (3000, (2999, -1, 1000), 6),
    "k50_past_intervals": (300, (None, 150, 7), 50),
    "k4_mixes_f32": (3000, (None, 2100, 333), 4),
}


@pytest.mark.parametrize("case", sorted(SPLIT_TRIM_CASES))
def test_the_split_with_ends_is_the_trimmed_unsplit(case):
    """forward_segmented / backward_segmented with the rows' live ends
    against forward_structured / backward_structured with them: pstates,
    alpha and dpi bitwise; ll and the gradients to 1e-12 of max (float64) or
    within the card's gates of float64 (float32); the counts: the live
    segments a row, its live sites split, and the fix sites of a row whose
    live end falls in its first segment zero."""
    L, lasts, K = SPLIT_TRIM_CASES[case]
    dtype = torch.float32 if case.endswith("f32") else torch.float64
    B, S = 3, len(lasts)
    dms = [_dm(r) for r in (0.05, 0.1, 0.2)]
    params, pi_rows = _params(dms)
    params = [x.to(dtype) for x in params]
    obs = _rows(L, lasts, seed=11)
    rng = np.random.default_rng(12)
    pi = torch.as_tensor(rng.dirichlet(np.ones(16), size=(B, S))).to(dtype)
    gbar = torch.as_tensor(rng.standard_normal((B, S))).to(dtype)
    abar0 = torch.as_tensor(rng.standard_normal((B, S, 16))).to(dtype)
    live = smc.live_periods(obs)
    n_per = smc.n_periods(L)
    plan = smc.segments(n_per, K)
    ll, alpha, pst = smc.forward_structured(params, pi, obs, True, live)
    ll_s, alpha_s, pst_s, fwd = smc.forward_segmented(params, pi, obs, True, smc.Plan(K, 0), live)
    assert torch.equal(pst_s, pst) and torch.equal(alpha_s, alpha)
    _, alpha_1, none, _ = smc.forward_segmented(params, pi, obs, False, smc.Plan(K, 0), live)
    assert none is None and torch.equal(alpha_1, alpha)
    grads, dpi = smc.backward_structured(params, obs, pst, gbar, abar0, live)
    grads_s, dpi_s, bwd = smc.backward_segmented(params, obs, pst, gbar, abar0, smc.Plan(K, 0),
                                                 live)
    assert torch.equal(dpi_s, dpi)
    if dtype == torch.float64:
        want_ll, want, ll_tol, grad_tol = ll, grads, 1e-12, 1e-12
    else:
        p64 = [x.double() for x in params]
        ll64, _, pst64 = smc.forward_structured(p64, pi.double(), obs, True, live)
        want, _ = smc.backward_structured(p64, obs, pst64, gbar.double(), abar0.double(), live)
        want_ll, ll_tol, grad_tol = ll64, 1e-5, 2e-5
    scale = float(want_ll.abs().max())
    np.testing.assert_allclose(ll_s.double().numpy(), want_ll.double().numpy(), rtol=ll_tol,
                               atol=ll_tol * scale)
    for name, got, ref in zip(PSMC_FIELDS[:6], grads_s, want):
        err = float((got.double() - ref.double()).abs().max())
        assert err <= grad_tol * (float(ref.abs().max()) + 1e-300), (name, err)
    P = plan.periods
    n_live = live.long()
    live_segs = torch.where(n_live > 0, (n_live - 1) // P + 1, 0)
    live_sites = torch.clamp(n_live * E, max=L)
    for c in (fwd, bwd):
        assert c["smc_segments"] == B * int(live_segs.sum())
        assert c["smc_split_sites"] == B * int(live_sites.sum())
        assert 0 <= c["smc_segments_resolved"] <= B * int((live_segs - 1).clamp(min=0).sum())
    if all(int(n) <= P for n in n_live):  # one live segment a row: nothing to fix
        assert fwd["smc_fix_sites"] == bwd["smc_fix_sites"] == 0


def test_split_ends_on_segment_boundaries_leave_the_next_segment_empty():
    """A row whose live end is a segment's last period runs no site of the
    next segment; one whose end is the next segment's first period runs one
    period there (the speculative pass's sites, B instances a row)."""
    L, K = 3000, 3
    plan = smc.segments(smc.n_periods(L), K)
    P = plan.periods
    obs = _rows(L, (P * E - 1, P * E), seed=13)
    live = smc.live_periods(obs)
    assert live.tolist() == [P, P + 1]
    params, _ = _params([_dm(0.1)])
    pi = torch.full((1, 2, 16), 1 / 16, dtype=torch.float64)
    _, _, _, c = smc.forward_segmented(params, pi, obs, False, smc.Plan(K, 0), live)
    assert c["smc_segments"] == 1 + 2 and c["smc_split_sites"] == P * E + (P + 1) * E


@pytest.mark.parametrize("shape", ["ragged", "genome"])
@pytest.mark.cuda
def test_trimmed_kernels_on_the_card(shape):
    """The trimmed kernels against the plain trimmed versions, and at a
    genome chunk's length the split's pstates and alpha bitwise the trimmed
    K = 1 kernels' (S = 1 and 5), with the live-end counters equal to the
    host's count of the padded sites (chip_smoke.py phase 3e)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 3e runs this check on the card")
    import chip_smoke

    dev = torch.device("cuda", 0)
    if shape == "ragged":
        chip_smoke.check_trim(torch, smc, dev)
    else:
        chip_smoke.check_trim_genome(torch, smc, dev)


def test_the_plain_split_names_its_ends_helpers():
    "split._ends: every period and the last segment K - 1 on whole rows; -1 where a row runs none."
    n_live, k_last = split._ends(None, 100, 32, (2, 3), "cpu")
    assert n_live.eq(100).all() and k_last.eq(3).all()
    n_live, k_last = split._ends(torch.tensor([0, 32, 33], dtype=torch.int32), 100, 32, (2, 3),
                                 "cpu")
    assert k_last.tolist() == [[-1, 0, 1]] * 2
