"""The plain reference against float64 autograd at small sizes."""

import numpy as np
import pytest
import torch

from benchmark.reference import fit as reference
from benchmark.reference import hmm, model, svgd
from benchmark.reference.hmm import Arith

PATTERN = "14*1+1*2"
THETA = 0.08


def cloud(P, seed=0):
    g = torch.Generator().manual_seed(seed)
    x0 = model.init_coordinates(PATTERN, 1e-4, 15.0, THETA, THETA)
    return x0 + 0.5 * torch.randn(P, x0.shape[0], generator=g, dtype=torch.float64)


def rows(S, L, seed=1):
    rng = np.random.default_rng(seed)
    r = (rng.random((S, L)) < 0.1).astype(np.int8)
    r[rng.random((S, L)) < 0.05] = -1
    return torch.as_tensor(r)


def test_history_round_trip():
    x = cloud(6)
    t, c, rho, rot, _ = model.history(x, PATTERN, THETA)
    assert t.shape == (6, 16) and (torch.diff(t) > 0).all()
    assert torch.allclose(model.coordinates(t, c, rho, THETA, PATTERN), x, atol=1e-12)


def test_hmm_is_a_distribution():
    A, e0, e1, pi, _, _ = model.hmm(cloud(5), PATTERN, THETA)
    assert torch.allclose(A.sum(-1), torch.ones(5, 16, dtype=torch.float64), atol=1e-6)
    assert torch.allclose(pi.sum(-1), torch.ones(5, dtype=torch.float64), atol=1e-12)
    assert torch.allclose(e0 + e1, torch.ones_like(e0))


@pytest.mark.parametrize("S, L, block", [(1, 1, None), (2, 37, None), (3, 100, 7), (2, 64, 64)])
def test_blocked_gradient_is_autograd_of_the_site_loop(S, L, block):
    x = cloud(4)
    A, e0, e1, pi, _, _ = model.hmm(x, PATTERN, THETA)
    A, e0, e1 = (v.detach().requires_grad_(True) for v in (A, e0, e1))
    pis = (pi.detach()[:, None, :] * torch.linspace(0.5, 1.5, S, dtype=torch.float64)[:, None]
           ).requires_grad_(True)
    obs = rows(S, L)
    ll = hmm.loglik_plain(A, e0, e1, pis, obs)
    want = torch.autograd.grad(ll.sum(), (A, e0, e1, pis))
    got_ll, *got = hmm.loglik_and_grad(A, e0, e1, pis, obs, Arith(), block=block)
    assert torch.allclose(got_ll, ll, rtol=1e-12, atol=1e-12)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-9, atol=1e-12 * w.abs().max())


def test_warmup_filter_is_the_normalized_site_loop():
    A, e0, e1, pi, _, _ = model.hmm(cloud(3), PATTERN, THETA)
    warm = rows(2, 21)
    got = hmm.warmup_filter(A, e0, e1, pi, warm, Arith())
    F = hmm.emission_table(e0, e1)
    a = pi[:, None, :].expand(3, 2, 16)
    for t in range(21):
        a = torch.matmul(a, A) * F[:, warm[:, t].long() + 1]
    assert torch.allclose(got, a / a.sum(-1, keepdim=True), rtol=1e-12)


def test_density_gradient_is_autograd_of_the_density():
    "prior + (N / S) x (filter, then body) + AFS, differentiated whole by autograd."
    P, overlap = 5, 9
    ch = rows(12, 40).numpy()
    afs = np.array([40.0, 17.0, 9.0, 6.0, 4.0])
    pb = reference.Problem(chunks=ch, overlap=overlap, afs=afs,
                           T=model.default_afs_transform(afs), theta=THETA, pattern=PATTERN,
                           alpha=0.5, beta=0.01, lr=0.1, S=2, x0=cloud(P).float(),
                           inds=torch.tensor([[3, 7]]))
    x = cloud(P, seed=3)
    got = reference.density_grad(pb, x, np.array([3, 7]), Arith())
    xg = x.clone().requires_grad_(True)
    A, e0, e1, pi, t, c = model.hmm(xg, PATTERN, THETA)
    r = torch.as_tensor(ch[[3, 7]])
    pib = hmm.warmup_filter(A, e0, e1, pi, r[:, :overlap], Arith())
    ll = hmm.loglik_plain(A, e0, e1, pib, r[:, overlap:])
    dens = (model.log_prior(xg, PATTERN, THETA, 0.5, 0.01)
            + model.log_afs(t, c, torch.as_tensor(afs), torch.as_tensor(pb.T))
            + 12 / 2 * ll.sum(1))
    want = torch.autograd.grad(dens.sum(), xg)[0]
    assert torch.allclose(got, want, rtol=1e-9, atol=1e-10 * want.abs().max())


def test_elpd_is_the_mean_held_out_density():
    "The held-out ELPD: the mean over particles of (filter, then body) on the subset, + AFS, no prior."
    P, overlap = 5, 9
    test = rows(10, 40, seed=4).numpy()
    afs = np.array([40.0, 17.0, 9.0, 6.0, 4.0])
    pb = reference.Problem(chunks=rows(12, 40).numpy(), overlap=overlap, afs=afs,
                           T=model.default_afs_transform(afs), theta=THETA, pattern=PATTERN,
                           alpha=0.5, beta=0.01, lr=0.1, S=2, x0=cloud(P).float(),
                           inds=torch.tensor([[3, 7]]), test_chunks=test,
                           test_afs=np.array([30.0, 12.0, 8.0, 5.0, 2.0]),
                           elpd_inds=np.array([6, 1, 4]))
    x = cloud(P, seed=5)
    A, e0, e1, pi, t, c = model.hmm(x, PATTERN, THETA)
    r = torch.as_tensor(test[[6, 1, 4]])
    pib = hmm.warmup_filter(A, e0, e1, pi, r[:, :overlap], Arith())
    ll = hmm.loglik_plain(A, e0, e1, pib, r[:, overlap:]).sum(1)
    want = ll + model.log_afs(t, c, torch.as_tensor(pb.test_afs), torch.as_tensor(pb.T))
    assert reference.elpd(pb, x) == pytest.approx(float(want.mean()), rel=1e-12)


def test_the_elpd_subset_is_every_chunk_or_a_seeded_draw():
    assert reference.elpd_draw(4, 5, None, 11, "cpu").tolist() == [0, 1, 2, 3]
    one = reference.elpd_draw(50, 1, None, 11, "cpu")
    assert len(one) == 4 and len(set(one.tolist())) == 4  # max(S, 4) distinct chunks
    assert one.tolist() == reference.elpd_draw(50, 1, None, 11, "cpu").tolist()
    assert len(reference.elpd_draw(50, 5, 7, 11, "cpu")) == 7


def test_the_elpd_subset_is_the_one_fit_draws():
    "The reference's draw against the program's own (fit's ELPD generator and HeldOutELPD.draw)."
    from phlash_tpu_torch import mcmc

    for seed, n, S in ((11, 50, 4), (2**33 + 5, 850, 5), (3, 6, 4)):
        _, gen = mcmc.generators(seed, torch.device("cpu"))
        held = mcmc.HeldOutELPD(init=None, kern=None, warmup=torch.zeros(n, 1), afs=None,
                                afs_transform=None, N=n, S=min(n, S))
        want = held.draw(gen).tolist()
        assert reference.elpd_draw(n, S, None, seed, "cpu").tolist() == want


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-12, -3.0 - 2.0**-20, 0.0])
    got = hmm.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -3.0, 0.0]
    bits = got.view(torch.int32) & 0x1FFF
    assert (bits == 0).all()


def test_direction_mean_and_half():
    x, g = cloud(6).float().double(), torch.randn(6, 18, dtype=torch.float64)
    full = svgd.direction(x, g, Arith())
    sq = ((x[:, None] - x[None]) ** 2).sum(-1)
    h = svgd.bandwidth(sq)
    K = torch.exp(-sq / h)
    want = (K @ g - 2 / h * (K @ x - K.sum(1, keepdim=True) * x)) / 6
    assert torch.allclose(full, want)
    assert not torch.allclose(svgd.direction(x, g, Arith(), half=True), full)


def test_amsgrad_first_step_is_the_sign():
    phi = torch.tensor([[2.0, -0.5, 1e-3]], dtype=torch.float64)
    st = svgd.init_state(phi)
    step = svgd.amsgrad(phi, st, 0.1)
    assert torch.allclose(step, 0.1 * torch.sign(phi), rtol=1e-4)  # eps = 1e-8 against 1e-3
