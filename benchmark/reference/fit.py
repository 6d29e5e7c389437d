"""The fit's first call worked out again: chunks, initial cloud, minibatch draws, k SVGD iterations.

From the contigs the harness made (benchmark/inputs.RefContig) and the
fit's options, `prepare` chunks the data as fit documents it (rows cut
into chunks of chunk_size + overlap windows that advance by chunk_size,
padded with missing windows; chunk_size by default a fifth of the
shortest contig, in windows), sums the AFS, takes the Watterson estimate
of theta, centres the cloud on a constant history, and draws from the
seed what fit draws from it: one torch.Generator on the fit's device,
seeded with the seed, gives the cloud's N(0, sigma) noise and then each
call's (k, S) minibatch rows.  `follow` then runs k SVGD iterations on
the model of reference/model.py and reference/hmm.py and the update of
reference/svgd.py, from the float32 cloud cast to the arithmetic's dtype.
The held-out autosome is chunked alike (its first max_samples rows), and
the subset every ELPD evaluation visits is drawn as fit documents it: from
a second torch.Generator on the device, seeded from
SeedSequence([seed, 0x0E1D]), a permutation's first elpd_samples (by
default max(S, 4)) entries, or every chunk when there are no more.
`elpd` is the held-out ELPD at a cloud: the mean over particles of those
chunks' log-likelihood and the held-out AFS term (no prior).

The reference imports nothing of the program; it takes the seed and the
harness's inputs, as the fit does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import hmm, model, svgd
from benchmark.reference.hmm import Arith

T1, TM = 1e-4, 15.0  # the default time grid's ends without a mutation rate
MEMORY = 24e9  # bytes of HMM states a block of particles may hold at once
ELPD_STREAM = 0x0E1D  # fit's derivation of the ELPD generator's seed


def chunk_rows(het: np.ndarray, overlap: int, chunk_size: int) -> np.ndarray:
    "(rows * chunks, overlap + chunk_size) int8 chunks of every row, row-major."
    data = het.clip(-1, 1).astype(np.int8)
    R, L = data.shape
    span = chunk_size + overlap
    n = max(1, -(-L // span))
    padded = np.pad(data, [[0, 0], [0, n * span - L]], constant_values=-1)
    cols = np.arange(n)[:, None] * chunk_size + np.arange(span)[None, :]
    return padded[:, cols].reshape(-1, span)


@dataclass
class Problem:
    chunks: np.ndarray  # (N, overlap + chunk_size) int8
    overlap: int
    afs: np.ndarray | None
    T: np.ndarray | None  # the AFS transform
    theta: float  # scaled mutation rate per window
    pattern: str
    alpha: float
    beta: float
    lr: float
    S: int
    x0: torch.Tensor  # (P, D) float32: the initial cloud
    inds: torch.Tensor  # (k, S) the first call's minibatch rows
    test_chunks: np.ndarray | None = None  # (N_test, overlap + chunk_size) int8
    test_afs: np.ndarray | None = None
    elpd_inds: np.ndarray | None = None  # the held-out chunks an ELPD visits

    @property
    def N(self) -> int:
        return len(self.chunks)


def prepare(ref: list, opts: dict, seed: int, device, k: int, ref_test=None) -> Problem:
    """The problem fit sets up from the contigs `ref`, the held-out contig
    `ref_test` (or None) and its options, and its first call's draws."""
    window, overlap = opts["window_size"], opts["overlap"]
    chunk_size = opts.get("chunk_size") or int(min(0.2 * c.length / window for c in ref))
    chunks = np.concatenate([chunk_rows(c.het, overlap, chunk_size) for c in ref])
    afss = [c.afs for c in ref if c.afs is not None]
    afs = np.sum(afss, 0) if afss else None
    S, niter = int(opts["minibatch_size"]), int(opts["niter"])
    if len(chunks) > 5 * S * niter:  # fit caps the resident chunks at what niter visits
        sel = torch.randperm(len(chunks), generator=torch.Generator().manual_seed(seed))
        chunks = chunks[sel[: 5 * S * niter].numpy()]
    body = chunks[:, overlap:]
    theta = float(body[body > -1].mean() / window)
    pattern = opts.get("pattern", "14*1+1*2")
    tw = theta * window
    x0 = model.init_coordinates(pattern, T1, TM, tw, tw).to(torch.float32).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    P = int(opts.get("num_particles", 500))
    noise = torch.randn(P, x0.shape[-1], generator=gen, dtype=torch.float32, device=device)
    particles = x0 + opts.get("sigma", 1.0) ** 0.5 * noise
    inds = torch.randint(len(chunks), (k, S), generator=gen, device=device)
    pb = Problem(chunks=chunks, overlap=overlap, afs=afs,
                 T=None if afs is None else model.default_afs_transform(afs),
                 theta=tw, pattern=pattern, alpha=opts.get("alpha", 0.0),
                 beta=opts.get("beta", 0.0), lr=opts.get("learning_rate", 0.1), S=S,
                 x0=particles, inds=inds)
    if ref_test is not None:
        pb.test_chunks = chunk_rows(ref_test.het[: opts.get("max_samples", 20)], overlap,
                                    chunk_size)
        pb.test_afs = ref_test.afs
        pb.elpd_inds = elpd_draw(len(pb.test_chunks), S, opts.get("elpd_samples"), seed, device)
    return pb


def elpd_draw(n: int, S: int, elpd_samples, seed: int, device) -> np.ndarray:
    "The held-out chunks every ELPD evaluation of fit visits (see the module's docstring)."
    m = min(n, int(elpd_samples or max(S, 4)))
    if m == n:
        return np.arange(n)
    state = int(np.random.SeedSequence([seed, ELPD_STREAM]).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(state)
    return torch.randperm(n, generator=gen, device=device)[:m].cpu().numpy()


def _hmm(pb: Problem, x: torch.Tensor, chunks: np.ndarray, batch: np.ndarray, ar: Arith,
         shift: int = 0):
    """The HMM of each particle x (P, D), the states its warm-up filter
    leaves on the chunks `batch`, the chunks' body rows on the device
    (shift plants a fault: each chunk's body is read `shift` places on),
    and the history (t, c)."""
    dev = x.device
    A, e0, e1, pi, t, c = model.hmm(x, pb.pattern, pb.theta)
    warm = torch.as_tensor(chunks[batch, : pb.overlap], device=dev)
    pib = hmm.warmup_filter(A, e0, e1, pi, warm, ar)
    body = torch.as_tensor(chunks[(batch + shift) % len(chunks), pb.overlap:], device=dev)
    return A, e0, e1, pib, body, t, c


def _afs_term(x: torch.Tensor, t, c, afs, T) -> torch.Tensor:
    as_t = lambda a: torch.as_tensor(a, dtype=x.dtype, device=x.device)  # noqa: E731
    return model.log_afs(t, c, as_t(afs), as_t(T))


def _rest(pb: Problem, x: torch.Tensor, t, c) -> torch.Tensor:
    "The prior and the training AFS term."
    rest = model.log_prior(x, pb.pattern, pb.theta, pb.alpha, pb.beta)
    return rest if pb.afs is None else rest + _afs_term(x, t, c, pb.afs, pb.T)


def _loglik(A, e0, e1, pib, body, ar: Arith) -> torch.Tensor:
    "(P, S) log-likelihoods, in blocks of particles that fit in MEMORY."
    P, S, M = pib.shape
    L = body.shape[1]
    blocks = -(-L // (math.isqrt(L - 1) + 1))
    per = max(1, int(MEMORY // (3 * S * blocks * M * M * A.element_size())))  # block matrices
    return torch.cat([hmm.loglik(A[g], e0[g], e1[g], pib[g], body, ar)
                      for g in torch.arange(P, device=A.device).split(per)])


def density_grad(pb: Problem, x: torch.Tensor, batch: np.ndarray, ar: Arith,
                 shift: int = 0) -> torch.Tensor:
    """(P, D) gradient of each particle's log density on the chunks `batch`:
    prior + (N / S) x the chunks' log-likelihood + AFS term; zero where the
    density or a gradient entry is not finite.  shift plants a fault: the
    likelihood reads the body of the chunk `shift` places on."""
    x = x.detach().requires_grad_(True)
    A, e0, e1, pib, body, t, c = _hmm(pb, x, pb.chunks, batch, ar, shift)
    rest = _rest(pb, x, t, c)
    P, S, M = pib.shape
    per = max(1, int(MEMORY // (body.shape[1] * S * M * x.element_size())))  # each site's state
    parts = [hmm.loglik_and_grad(A[g].detach(), e0[g].detach(), e1[g].detach(),
                                 pib[g].detach(), body, ar)
             for g in torch.arange(P, device=x.device).split(per)]
    ll, dA, de0, de1, dpi = (torch.cat(z) for z in zip(*parts))
    w = pb.N / pb.S
    torch.autograd.backward([rest.sum(), A, e0, e1, pib], [None, w * dA, w * de0, w * de1, w * dpi])
    g = x.grad
    finite = torch.isfinite(rest.detach() + w * ll.sum(1))
    g = torch.where(finite[:, None], g, torch.zeros_like(g))
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def follow(pb: Problem, ar: Arith = Arith(), fault: str | None = None):
    """(cloud after len(pb.inds) iterations, the first iteration's gradient),
    both (P, D) in ar's dtype.  fault plants one of the faults a training
    cell can have: "half" (the direction's mean over half the particles),
    "shifted" (the likelihood reads each minibatch chunk's successor's body)."""
    x = pb.x0.to(ar.dtype)
    state = svgd.init_state(x)
    first = None
    for batch in pb.inds.cpu().numpy():
        g = density_grad(pb, x, batch, ar, shift=int(fault == "shifted"))
        first = g if first is None else first
        phi = svgd.direction(x, g, ar, half=fault == "half")
        x = x + svgd.amsgrad(phi, state, pb.lr)
    return x.detach(), first


@torch.no_grad()
def density(pb: Problem, x: torch.Tensor, ar: Arith = Arith()) -> torch.Tensor:
    """(P,) log density of the particles x on every chunk the call visits
    (the k minibatches at once): prior + (N / S) x the chunks'
    log-likelihood / k + AFS term, in ar's arithmetic."""
    x = x.to(ar.dtype)
    A, e0, e1, pib, body, t, c = _hmm(pb, x, pb.chunks, pb.inds.cpu().numpy().reshape(-1), ar)
    ll = _loglik(A, e0, e1, pib, body, ar)
    return _rest(pb, x, t, c) + pb.N / pb.S * ll.sum(1) / len(pb.inds)


@torch.no_grad()
def elpd(pb: Problem, x: torch.Tensor, ar: Arith = Arith()) -> float:
    """The held-out ELPD at the particles x, as fit evaluates it after a
    call: the mean over particles of the held-out chunks' log-likelihood
    (every evaluation's subset, pb.elpd_inds) plus the held-out AFS term
    under the training transform, in ar's arithmetic."""
    x = x.to(ar.dtype)
    A, e0, e1, pib, body, t, c = _hmm(pb, x, pb.test_chunks, pb.elpd_inds, ar)
    total = _loglik(A, e0, e1, pib, body, ar).sum(1)
    if pb.test_afs is not None and pb.T is not None:
        if pb.T.shape[1] != len(pb.test_afs):
            raise ValueError("the held-out AFS does not fit the training transform")
        total = total + _afs_term(x, t, c, pb.test_afs, pb.T)
    return float(total.double().mean())
