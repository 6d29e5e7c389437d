"""Operations and least times of a cell's work, from the frozen counts at its shapes.

An SVGD iteration runs B2 + B3 twice (the warm-up filter over the overlap
and the likelihood over the chunk body, each on P x S instances), A1 and A2
once, and S1, S2 and S3 once; a held-out ELPD runs B1 twice (the filter
and the body, on P x S_elpd instances) and A1 once.  The counts are the
algorithm's, from shapes (benchmark/frozen/roofline.py): they stay the
same whatever kernels a later change runs them with.
"""

from __future__ import annotations

from benchmark.frozen import roofline as rf


def _lengths(sh):
    return [L for L in (sh.overlap, sh.chunk_size) if L]


def hmm_bound_s(sh, iters: int, calls: int) -> float:
    "Least seconds of B1-B3 over `iters` iterations and `calls` ELPDs."
    ms = 0.0
    for L in _lengths(sh):
        ms += iters * (rf.kernel_bound("smc_forward_residuals", sh.M, sh.P, sh.S, L)[0]
                       + rf.kernel_bound("smc_backward", sh.M, sh.P, sh.S, L)[0])
        ms += calls * rf.kernel_bound("smc_forward", sh.M, sh.P, sh.S_elpd, L)[0]
    return ms / 1e3


def svgd_flops(P: int, D: int) -> float:
    "S1 + S2 + S3's operations on a cloud of P particles of D coordinates (svgd_bound's counts)."
    m = P * (P - 1) // 2
    return 3 * D * m + m + P * P * (8 * D + 2) + rf.AMSGRAD_FLOPS * P * D


def iteration_flops(sh) -> float:
    "Operations of one SVGD iteration."
    hmm = sum((rf.flops_per_site("smc_forward", sh.M) + rf.flops_per_site("smc_backward", sh.M))
              * sh.P * sh.S * L for L in _lengths(sh))
    asm = sh.P * (1 + rf.GRAD_PASSES) * rf.assembly_flops(sh.M, sh.D, sh.nm1, sh.R)
    return hmm + asm + svgd_flops(sh.P, sh.D)


def elpd_flops(sh) -> float:
    "Operations of one held-out ELPD."
    hmm = sum(rf.flops_per_site("smc_forward", sh.M) * sh.P * sh.S_elpd * L for L in _lengths(sh))
    return hmm + sh.P * rf.assembly_flops(sh.M, sh.D, sh.nm1, sh.R)
