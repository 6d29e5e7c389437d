"""Simulation for validation: three tiers, as in phlash_tpu/sim.py.

* `simulate_hmm` / `simulate_dataset` (phlash_tpu/sim.py:41-105) draw
  observation sequences from the discretized SMC' HMM of a
  DemographicModel, on the device.  The law is phlash_tpu's; the draws are
  torch's, not JAX's, so a seed gives other sequences.  There is no loop
  over the windows: each window's uniform u_t defines the map
  f_t(s) = searchsorted(cumsum A[s], u_t) on the M states, and the path
  s_t = f_t(... f_1(s_0)) is an inclusive scan of map composition,
  (f o g)[s] = f[g[s]], one gather on an (L, M) table per pass,
  ceil(log2 L) passes.  `hmm_path_stats` holds a path to its law (het
  rate, state marginal and transition counts).
* `simulate_smc_continuous` (phlash_tpu/sim.py:111-265): the exact
  continuous-time SMC' process in numpy.  The draws are the same numpy
  `default_rng(seed)` calls in the same order, so a seed gives the het
  matrix that phlash_tpu.sim gives, bit for bit, for the same model.
* the published-catalog tiers (phlash_tpu/sim.py:270-530): stdpopsim
  models through msprime, or through an external `scrm` process above
  SCRM_RHO_THRESHOLD, and the msprime truth.  demes, msprime, stdpopsim
  and scrm stay optional; each is imported where it is used.
"""

from __future__ import annotations

import logging
from typing import Iterable

import numpy as np
import torch

from phlash_tpu_torch.convert import to_numpy
from phlash_tpu_torch.data import RawContig
from phlash_tpu_torch.kernel import resolve_device
from phlash_tpu_torch.params import PSMCParams
from phlash_tpu_torch.size_history import DemographicModel, SizeHistory
from phlash_tpu_torch.transition import transition_matrix

logger = logging.getLogger(__name__)


# -- the discretized HMM, on the device ----------------------------------------


def hmm_arrays(dm: DemographicModel, device="cpu"):
    """(A (M, M), pi (M,), emis1 (M,)) of the HMM that simulate_hmm draws
    from, float64: the transition matrix clipped to [1e-20, 1] with rows
    renormalized (a float32 assembly can leave entries of -1e-8), the
    initial law and the het emission, as phlash_tpu.sim.simulate_hmm
    builds them."""
    dm = DemographicModel(eta=SizeHistory(t=dm.eta.t.to(device, torch.float64),
                                          c=dm.eta.c.to(device, torch.float64)),
                          theta=dm.theta,
                          rho=None if dm.rho is None else torch.as_tensor(
                              dm.rho, dtype=torch.float64, device=device))
    pp = PSMCParams.from_dm(dm)
    A = transition_matrix(dm).clamp(1e-20, 1.0)
    return A / A.sum(1, keepdim=True), pp.pi, pp.emis1


def simulate_path(A: torch.Tensor, pi: torch.Tensor, emis1: torch.Tensor, L: int,
                  generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """(hidden states (L,) int64, observations (L,) int8) of the HMM, on
    A's device: s_0 ~ pi, then L states s_1..s_L by A, each emitting a het
    with probability emis1[s_t].  The path is the composition scan of the
    module docstring: no Python loop over the windows."""
    M = A.shape[0]
    dev = A.device
    u0 = torch.rand((1,), generator=generator, dtype=torch.float64, device=dev)
    u = torch.rand((L,), generator=generator, dtype=torch.float64, device=dev)
    v = torch.rand((L,), generator=generator, dtype=torch.float64, device=dev)
    s0 = torch.searchsorted(torch.cumsum(pi, 0), u0, right=True).clamp_(max=M - 1)
    # f_t(s) for every window t and state s: (L, M), uint8
    C = torch.cumsum(A, 1).contiguous()
    F = torch.searchsorted(C, u.expand(M, L).contiguous(), right=True).clamp_(max=M - 1)
    F = F.to(torch.uint8).T.contiguous()
    # inclusive scan: after the pass of `off`, F[t] = f_t o ... o f_{max(0, t - 2 off + 1)}
    off = 1
    while off < L:
        F[off:] = torch.gather(F[off:], 1, F[:-off].long())
        off *= 2
    states = F[:, s0].reshape(L).long()
    obs = (v < emis1[states]).to(torch.int8)
    return states, obs


def _streams(seed, device) -> tuple[torch.Generator, torch.Generator]:
    """(path generator, missing-data generator) on the device: from an int
    seed two independent SeedSequence streams; from a Generator, that
    generator and one seeded by a draw from it."""
    if isinstance(seed, torch.Generator):
        miss = int(torch.randint(2**62, (1,), generator=seed, device=seed.device))
        return seed, torch.Generator(device=seed.device).manual_seed(miss)
    main, miss = np.random.SeedSequence(int(seed)).generate_state(2, dtype=np.uint64)
    return (torch.Generator(device=device).manual_seed(int(main)),
            torch.Generator(device=device).manual_seed(int(miss)))


def simulate_hmm(dm: DemographicModel, L: int, seed: int | torch.Generator = 0,
                 window_size: int = 100, missing_frac: float = 0.0,
                 device="cuda") -> RawContig:
    """Simulate one diploid binned het sequence of L windows from `dm`
    (window-scaled theta and rho) on `device`.

    seed: an int or a torch.Generator on the device (phlash_tpu takes a JAX
    key).  missing_frac: the fraction of windows masked to -1, drawn from a
    stream of its own.  Returns a RawContig with a (1, L) int8 het matrix
    on the host and a trivial AFS."""
    dev = resolve_device(device)
    gen, gen_miss = _streams(seed, dev)
    A, pi, emis1 = hmm_arrays(dm, dev)
    _, obs = simulate_path(A, pi, emis1, L, gen)
    if missing_frac > 0:
        miss = torch.rand((L,), generator=gen_miss, dtype=torch.float64, device=dev) < missing_frac
        obs = torch.where(miss, torch.full_like(obs, -1), obs)
    return RawContig(het_matrix=obs.cpu().numpy()[None], afs=np.ones(1), window_size=window_size)


def simulate_dataset(dm: DemographicModel, n_contigs: int = 2, L: int = 100_000, seed: int = 0,
                     window_size: int = 100, device="cuda") -> tuple[list[RawContig], RawContig]:
    """Simulate (train contigs, test contig) from one demographic model, each
    from its own of n_contigs + 1 independent streams of `seed`."""
    seeds = [int(s.generate_state(1, dtype=np.uint64)[0])
             for s in np.random.SeedSequence(seed).spawn(n_contigs + 1)]
    contigs = [simulate_hmm(dm, L, s, window_size, device=device) for s in seeds]
    return contigs[:-1], contigs[-1]


def stationary_law(A: np.ndarray) -> np.ndarray:
    "The stationary law pi' of the transition matrix A (pi' A = pi'), float64."
    A = np.asarray(A, dtype=np.float64)
    M = len(A)
    lhs = np.vstack([A.T - np.eye(M), np.ones((1, M))])
    return np.linalg.lstsq(lhs, np.r_[np.zeros(M), 1.0], rcond=None)[0]


def _asymptotic_cov(F: np.ndarray, A: np.ndarray, pi: np.ndarray) -> np.ndarray:
    """lim L Cov of the window means of the functions F (M, k) of the
    stationary chain A: pi(f (2Z - I) g) for the centred f, g, with Z the
    fundamental matrix (I - A + 1 pi')^-1."""
    M = len(A)
    Z = np.linalg.inv(np.eye(M) - A + np.outer(np.ones(M), pi))
    Fc = F - pi @ F
    G = Fc.T @ (pi[:, None] * ((2.0 * Z - np.eye(M)) @ Fc))
    return (G + G.T) / 2.0


def hmm_path_stats(states: np.ndarray, obs: np.ndarray, A: np.ndarray, emis1: np.ndarray,
                   min_entries: float = 50.0) -> dict:
    """How a simulated path (states s_1..s_L, observations) agrees with its
    HMM, by the central limit theorem for Markov chains:

    het_rate, het_expected = sum pi' emis1 (pi' the stationary law of A)
    and het_se, its standard error at this L (the emission's variance plus
    the autocorrelation of emis1(s_t), from A's fundamental matrix);
    marginal_p: the state marginal against pi', a chi-square on states
    pooled in order so that each cell expects at least `min_entries`
    entries, with the cells' asymptotic covariance; transition_p: the
    transition counts against A, a chi-square over the rows (cells of a
    row pooled below an expected count of 5), valid by the Markov property.
    """
    from scipy.stats import chi2

    states, obs = np.asarray(states), np.asarray(obs)
    A, emis1 = np.asarray(A, np.float64), np.asarray(emis1, np.float64)
    L, M = len(states), len(A)
    pi = stationary_law(A)
    e = pi @ emis1
    var = pi @ (emis1 * (1.0 - emis1)) + _asymptotic_cov(emis1[:, None], A, pi)[0, 0]
    out = dict(L=L, het_rate=float((obs == 1).mean()), het_expected=float(e),
               het_se=float(np.sqrt(var / L)))

    # marginal: cells of consecutive states, each entered >= min_entries times in expectation
    cells, cur = [], []
    for s in range(M):
        cur.append(s)
        out_of = np.setdiff1d(np.arange(M), cur)
        if L * (pi[cur] @ A[np.ix_(cur, out_of)].sum(1)) >= min_entries:
            cells.append(cur)
            cur = []
    if cur:
        if cells:
            cells[-1] += cur
        else:
            cells.append(cur)
    F = np.zeros((M, len(cells)))
    for k, cell in enumerate(cells):
        F[cell, k] = 1.0
    d = np.bincount(states, minlength=M) @ F / L - pi @ F
    G = _asymptotic_cov(F, A, pi)
    stat = float(L * d @ np.linalg.pinv(G, rcond=1e-10, hermitian=True) @ d)
    out.update(marginal_cells=len(cells), marginal_chi2=stat,
               marginal_p=float(chi2.sf(stat, len(cells) - 1)))

    # transitions: per row, multinomial counts against A
    C = np.bincount(states[:-1] * M + states[1:], minlength=M * M).reshape(M, M).astype(float)
    stat, df = 0.0, 0
    for i in range(M):
        n = C[i].sum()
        if n < 20:
            continue
        E, O = n * A[i], C[i]
        order = np.argsort(E)
        small, acc = [], 0.0
        for j in order:  # pool the least expected cells until they reach 5
            if acc >= 5.0 and E[j] >= 5.0:
                break
            small.append(j)
            acc += E[j]
        big = np.setdiff1d(np.arange(M), small)
        cells_E = np.r_[E[big], acc]
        cells_O = np.r_[O[big], O[small].sum()]
        stat += float(((cells_O - cells_E) ** 2 / cells_E).sum())
        df += len(cells_E) - 1
    out.update(transition_chi2=stat, transition_df=df,
               transition_p=float(chi2.sf(stat, df)) if df else 1.0)
    return out


def _inv_hazard(t_grid: np.ndarray, c: np.ndarray, t0: float, E: float, mult: float = 1.0,
                cap: float = np.inf) -> float:
    """Solve int_{t0}^{h} mult * c(s) ds = E for h, c piecewise constant.

    t_grid: (K,) epoch starts (t_grid[0] == 0), last epoch open.  Exact
    inversion of the piecewise-linear cumulative hazard.  If the solution
    would exceed `cap`, returns `cap` with the remaining hazard unspent (the
    caller reads h >= cap as "escaped past the cap").
    """
    k = int(np.searchsorted(t_grid, t0, side="right") - 1)
    h = t0
    while h < cap:
        end = min(t_grid[k + 1] if k + 1 < len(t_grid) else np.inf, cap)
        rate = mult * c[k]
        step = (end - h) * rate
        if E <= step or not np.isfinite(end):
            return min(h + E / rate, cap)
        E -= step
        h = end
        if h < cap:
            k += 1
    return cap


def simulate_smc_continuous(dm: DemographicModel, L: int, seed: int = 0, window_size: int = 100,
                            n_samples: int = 1) -> RawContig:
    """Simulate a diploid het sequence of L windows from the continuous SMC'
    process of `dm` (window-scaled theta and rho).

    The TMRCA path is piecewise constant between recombinations, which
    arrive at genome-distance rate 2 rho s; each detaches a lineage at
    height Uniform(0, s) that re-coalesces against hazard 2 c(h) below s
    (half of those rejoin its own branch and leave the TMRCA unchanged) and
    c(h) above it.  Het sites are a Poisson process at rate theta s a window,
    binned to windows.  Each of the n_samples rows is an independent path;
    with n_samples > 1 no AFS is emitted.
    """
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_samples):
        starts, tmrca = _segments_smc_continuous(dm, L, rng)
        lengths = np.diff(starts)

        # Poisson mutations at rate theta * s per window of genome distance
        n_mut = rng.poisson(float(dm.theta) * tmrca * lengths)
        total = int(n_mut.sum())
        obs = np.zeros(L, dtype=np.int8)
        if total:
            seg_of = np.repeat(np.arange(len(lengths)), n_mut)
            pos = starts[seg_of] + rng.random(total) * lengths[seg_of]
            obs[np.minimum(pos.astype(np.int64), L - 1)] = 1
        rows.append(obs)
    afs = np.ones(1) if n_samples == 1 else None
    return RawContig(het_matrix=np.stack(rows), afs=afs, window_size=window_size)


def _segments_smc_continuous(dm: DemographicModel, L: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """The TMRCA path of the continuous SMC' process over [0, L] windows:
    (starts, tmrca), len(starts) == len(tmrca) + 1, the path is tmrca[i] on
    [starts[i], starts[i+1]).  rng: a np.random.Generator or a seed."""
    if isinstance(rng, int):
        rng = np.random.default_rng(rng)
    t_grid = to_numpy(dm.eta.t).astype(np.float64)
    c = to_numpy(dm.eta.c).astype(np.float64)
    rho = float(dm.rho if dm.rho is not None else dm.theta)

    s = _inv_hazard(t_grid, c, 0.0, rng.standard_exponential())  # TMRCA ~ pi
    x = 0.0
    seg_starts, seg_tmrca = [0.0], [s]
    while True:
        # recombination events arrive at genome-distance rate 2 * rho * s
        x += rng.standard_exponential() / (2.0 * rho * s)
        if x >= L:
            break
        # detach a lineage at height Uniform(0, s); float it upward against
        # hazard 2c below s (two available partners), capping the draw at s
        u = rng.uniform(0.0, s)
        h = _inv_hazard(t_grid, c, u, rng.standard_exponential(), mult=2.0, cap=s)
        if h < s:
            # coalesced below s: half the events rejoin the original branch
            # (invisible: TMRCA unchanged), half hit the other branch
            if rng.random() < 0.5:
                s = h
            else:
                continue
        else:
            # floating above s: single partner left, hazard c(h)
            s = _inv_hazard(t_grid, c, s, rng.standard_exponential())
        seg_starts.append(x)
        seg_tmrca.append(s)
    seg_starts.append(float(L))
    return np.asarray(seg_starts), np.asarray(seg_tmrca)


# -- demography presets, float64 ----------------------------------------------


def constant_demography(theta: float = 1e-2, rho: float = None, M: int = 16) -> DemographicModel:
    return DemographicModel.default(pattern=f"{M}*1", theta=theta, rho=rho)


def _with_rates(base: DemographicModel, c: np.ndarray) -> DemographicModel:
    eta = SizeHistory(t=base.eta.t, c=torch.as_tensor(c, dtype=base.eta.t.dtype))
    return DemographicModel(eta=eta, theta=base.theta, rho=base.rho)


def zigzag_demography(theta: float = 1e-2, M: int = 16) -> DemographicModel:
    "A zigzag-style size history exercising sharp rate changes."
    base = DemographicModel.default(pattern=f"{M}*1", theta=theta)
    return _with_rates(base, np.exp(np.sin(np.linspace(0.0, 3.0 * np.pi, M)) * 1.5))


def bottleneck_demography(theta: float = 1e-2, M: int = 16) -> DemographicModel:
    base = DemographicModel.default(pattern=f"{M}*1", theta=theta)
    c = np.ones(M)
    c[M // 3: M // 2] = 10.0  # 10x higher coalescence = crash
    return _with_rates(base, c)


# -- scrm subprocess tier -----------------------------------------------------

# above this scaled recombination rate (4 N0 r L) msprime's exact ARG sampler
# becomes impractically slow and the SMC-approximating scrm takes over
SCRM_RHO_THRESHOLD = 1e5


def mean_coal_N0(model, populations: list[str]) -> float:
    """Effective N0 = (mean pairwise coalescence time) / 2 for the sampled
    populations.  `model`: a stdpopsim DemographicModel (needs msprime)."""
    dbg = model.model.debug()
    if len(populations) == 1:
        lineages = {populations[0]: 2}
    else:
        assert len(populations) == 2
        lineages = {p: 1 for p in populations}
    return float(dbg.mean_coalescence_time(lineages)) / 2.0


def build_scrm_command(graph, samples_per_deme: list[int], N0: float, theta: float, rho: float,
                       L: int, seed: int) -> list[str]:
    """The scrm argv for one chromosome.  `graph` is a demes.Graph, whose
    demography demes.to_ms renders; --transpose-segsites (parsed by
    parse_scrm_stream) and -oSFS; more than 200 haplotypes get the
    `-l 100r` window approximation.  The executable is $SCRM_PATH, default
    "scrm"."""
    import os
    import shlex

    import demes

    n_hap = sum(samples_per_deme)
    demo_flags = shlex.split(demes.to_ms(graph, N0=N0, samples=samples_per_deme))
    argv = [os.environ.get("SCRM_PATH", "scrm"), str(n_hap), "1"]
    argv += demo_flags
    argv += ["-t", str(theta), "-r", str(rho), str(int(L))]
    argv += ["--transpose-segsites", "-SC", "abs", "-p", "14", "-oSFS", "-seed", str(seed)]
    if n_hap > 200:
        argv += ["-l", "100r"]
    return argv


def parse_scrm_stream(lines: Iterable[str], window_size: int = 100) -> RawContig:
    """Parse `scrm ... --transpose-segsites` output into a binned RawContig.

    The stream: the echoed command line (which gives L and the haplotype
    count), a preamble, a header line starting with "position", then one
    line a segregating site, `position time hap0 hap1 ...`.  Haplotypes 2i
    and 2i + 1 are diploid i; a window counts the sites where the pair
    differs, and the derived-allele count feeds the AFS."""
    it = iter(lines)
    argv = next(it).split()
    if not argv or "scrm" not in argv[0]:
        raise ValueError(f"not an scrm stream (first line: {' '.join(argv[:4])!r})")
    n_hap = int(argv[1])
    if n_hap % 2:
        raise ValueError("scrm output must have an even haplotype count")
    L = int(float(argv[argv.index("-r") + 2]))
    n_dip = n_hap // 2

    for line in it:
        if line.startswith("position"):
            break
    else:
        raise ValueError("no transposed-segsites section found in scrm output")

    W = -(-L // window_size)
    het = np.zeros((n_dip, W), dtype=np.int32)
    afs = np.zeros(max(n_hap - 1, 1), dtype=np.int64)
    for line in it:
        if not line.strip() or line.startswith(("SFS:", "//")):
            continue
        fields = line.split()
        pos = min(int(float(fields[0])), L - 1)
        alleles = np.frombuffer(" ".join(fields[2:]).replace(" ", "").encode(),
                                dtype=np.uint8) - ord("0")
        if alleles.size != n_hap:
            raise ValueError(f"variant row has {alleles.size} haplotypes, expected {n_hap}")
        pairs = alleles.reshape(n_dip, 2)
        het[:, pos // window_size] += pairs[:, 0] != pairs[:, 1]
        k = int(alleles.sum())
        if 0 < k < n_hap:
            afs[k - 1] += 1
    return RawContig(het_matrix=het.clip(-1, 127).astype(np.int8), afs=afs,
                     window_size=window_size)


def simulate_scrm(model, chrom, populations: dict[str, int], N0: float, seed: int,
                  window_size: int = 100) -> RawContig:
    """Simulate one stdpopsim contig through an external scrm process.
    model / chrom: a stdpopsim DemographicModel / Contig.  Raises if the
    scrm executable ($SCRM_PATH, default "scrm") fails."""
    import subprocess

    (interval,) = chrom.interval_list[0]
    assert interval[0] == 0.0
    L = int(interval[1])
    theta = 4 * N0 * chrom.mutation_rate * L
    rho = 4 * N0 * float(chrom.recombination_map.rate[0]) * L
    graph = model.model.to_demes()
    samples = [0] * len(graph.demes)
    names = [d.name for d in graph.demes]
    for pop, n in populations.items():
        samples[names.index(pop)] += 2 * n
    argv = build_scrm_command(graph, samples, N0, theta, rho, L, seed)
    logger.debug("running %s", " ".join(argv))
    with subprocess.Popen(argv, stdout=subprocess.PIPE, text=True, bufsize=1) as proc:
        contig = parse_scrm_stream(proc.stdout, window_size)
    if proc.returncode:
        raise RuntimeError(f"scrm exited with status {proc.returncode}")
    return contig


# -- stdpopsim / msprime tier -------------------------------------------------


def _find_stdpopsim_model(species_id: str, model_id: str):
    import stdpopsim

    species = stdpopsim.get_species(species_id)
    if model_id == "Constant":
        return species, stdpopsim.PiecewiseConstantSize(species.population_size)
    return species, species.get_demographic_model(model_id)


def stdpopsim_dataset(species_id: str, model_id: str, populations: dict[str, int],
                      contigs: list[str] = None, seed: int = 1, options: dict = None) -> dict:
    """Simulate a published stdpopsim catalog model into Contigs.

    Chromosomes whose scaled recombination rate 4 N0 r L exceeds
    SCRM_RHO_THRESHOLD go through an external scrm process (msprime if it
    fails); the others through msprime.  options: engine ("scrm" or
    "msprime" forces one), length_multiplier.  contigs: chromosome ids
    (default: the diploid, recombining, numeric ones).  Returns {"data":
    {chrom: Contig}, "truth": DemographicModel}.  Needs stdpopsim."""
    import re

    import stdpopsim

    from phlash_tpu_torch.data import TreeSequenceContig

    options = options or {}
    species, model = _find_stdpopsim_model(species_id, model_id)
    engine = stdpopsim.get_engine("msprime")
    mu = species.genome.chromosomes[0].mutation_rate
    if contigs is None:
        keep = [c.id for c in species.genome.chromosomes
                if c.ploidy == 2 and c.recombination_rate > 0 and re.match(r"\d+", c.id)]
    else:
        keep = list(contigs)
    pop_dict = {pop.name: 0 for pop in model.populations}
    pop_dict.update(populations)
    samples = {p: n for p, n in pop_dict.items() if n > 0}
    engine_opt = options.get("engine")  # None = auto, "msprime", "scrm"
    N0 = None
    data = {}
    for i, chrom in enumerate(keep):
        spec = species.get_contig(chrom, mutation_rate=mu,
                                  length_multiplier=options.get("length_multiplier", 1.0))
        choice = engine_opt
        if choice is None:
            if N0 is None:
                N0 = mean_coal_N0(model, list(samples))
            L_c = float(spec.interval_list[0][0, 1])
            rho_scaled = 4 * N0 * float(spec.recombination_map.rate[0]) * L_c
            choice = "scrm" if rho_scaled > SCRM_RHO_THRESHOLD else "msprime"
        if choice == "scrm":
            if N0 is None:
                N0 = mean_coal_N0(model, list(samples))
            try:
                data[chrom] = simulate_scrm(model, spec, samples, N0, seed + i)
                continue
            except Exception as e:
                logger.warning("scrm failed for %s (%s); using msprime", chrom, e)
        ts = engine.simulate(model, spec, samples, seed=seed + i)
        nodes = [tuple(ind.nodes) for ind in ts.individuals()]
        data[chrom] = TreeSequenceContig(ts, nodes=nodes)
    truth_eta = compute_truth_msprime(model.model, list(populations))
    return {"data": data, "truth": DemographicModel(eta=truth_eta, theta=mu, rho=None)}


def compute_truth_msprime(demography, populations: list[str], t_min: float = 1e1,
                          t_max: float = None) -> SizeHistory:
    """The pairwise coalescence-rate trajectory of an msprime demography on
    a geometric grid of 1000 times, float64."""
    dbg = demography.debug()
    if t_max is None:
        t_max = max(1e5, float(dbg.epoch_start_time.max()) + 1.0)
    t = np.geomspace(t_min, t_max, 1000)
    if len(populations) == 1:
        lineages = {populations[0]: 2}
    else:
        assert len(populations) == 2
        lineages = {p: 1 for p in populations}
    rates, _ = dbg.coalescence_rate_trajectory(t, lineages)
    return SizeHistory(t=torch.as_tensor(t, dtype=torch.float64),
                       c=torch.as_tensor(np.asarray(rates), dtype=torch.float64))


def compute_truth(dm: DemographicModel, t_grid=None) -> SizeHistory:
    """The pairwise coalescence-rate trajectory of a model on a time grid
    (default: 1000 geometric points up to 4 times its last breakpoint)."""
    if t_grid is None:
        t_grid = np.geomspace(1e-4, 4 * float(dm.eta.t[-1]), 1000)
    t = torch.as_tensor(np.asarray(t_grid), dtype=dm.eta.t.dtype, device=dm.eta.t.device)
    return SizeHistory(t=t, c=dm.eta(t))
