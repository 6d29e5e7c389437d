"""The least time an H100 could take for each hand kernel's work.

One count, read by `python -m phlash_tpu_torch bench` (bench.py) and by
chip_smoke.py's kernel table.  A kernel's bound is the larger of two times:
the float32 operations it does on its inputs over the card's float32 peak
outside the tensor cores, and the bytes it must move (each input read once,
each output written once) over the card's memory rate.  Both peaks are the
data sheet's for the H100 SXM at its full 700 W; a card set below that runs
slower, so a share against this bound is stated beside the card's power
limit.

Kernels, by the names of the kernel table (ops/smc.py, ops/packed.py):
    smc_forward             B1: forward, no residuals
    smc_forward_residuals   B2: forward with the period-start states
    smc_backward            B3: adjoint of B2
    packed_forward          B4 without checkpoints
    packed_forward_ckpt     B4 with its checkpoints (the fwd+grad pass)
    packed_backward         B5: adjoint of B4
and, by `assembly_bound` (ops/assembly.py, in float32 or float64):
    assembly_forward        A1: coordinates -> leaves, prior, AFS term
    assembly_backward       A2: their gradient
The SMC' kernels are bound by neither count but by the instructions their
chain issues: `issue_per_site` / `shuffles_per_site` count them, and
`issue_share` reads a time against the data-sheet issue ceiling or the
shuffle path (the bench's sm_*_peak_fraction_*; ops/peak.py measures
what the card sustains).
"""

from __future__ import annotations

PEAK_FP32 = 67e12  # FLOP/s: H100 SXM float32 outside the tensor cores (data sheet, 700 W)
PEAK_FP64 = 34e12  # FLOP/s: H100 SXM float64 outside the tensor cores (data sheet, 700 W)
PEAK_BYTES = 3.35e12  # B/s: H100 SXM HBM3
SMS = 132  # H100 SXM streaming multiprocessors
# The SM clock PEAK_FP32 implies (132 SMs x 128 FP32 lanes x 2 FLOP an FFMA):
# 1.98 GHz.  phlash_tpu's bench derives its TPU clock the same way, from its
# data-sheet peak (bench.py:180-187).
CLOCK = PEAK_FP32 / (SMS * 128 * 2)
# Data-sheet pipe ceilings, in warp-instructions a second: an SM has four
# partitions, each dispatching one warp-instruction a clock and each with a
# 32-lane FP32 pipe (4 warp-FFMA a clock); warp shuffles go through one
# path at 32 results a clock (1 warp-SHFL).
ISSUE_PEAK = 4 * SMS * CLOCK
FFMA_PEAK = 4 * SMS * CLOCK
SHFL_PEAK = 1 * SMS * CLOCK
SMC_PERIOD = 8  # sites between rescalings: ops/smc.NORM_EVERY, a period-start state each
PACKED_PERIOD = 8  # sites between checkpoints: ops/packed.DEFAULT_SEG

KERNELS = ("smc_forward", "smc_forward_residuals", "smc_backward", "packed_forward",
           "packed_forward_ckpt", "packed_backward")


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time for `flops` operations at `peak`
    (float32 by default) and `nbytes` of device-memory traffic, whichever
    is larger."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# float32 operations per live site of one instance, counted from the kernels'
# source at M states (a fused multiply-add counts as 2):
#   smc_forward   S(a): M adds; per state b*S + d*a + vv*P: 5, P += u*a: 2;
#                 emission: M; per 8-site period: sum, M divisions, log, add
#   smc_backward  the period rebuild (as the forward) + per site in reverse:
#                 S(x), u*x, P(.): 3M; per state v: 5, v*y, route, f*y: 3,
#                 db/dd/dvv: 6; vv*vbar, S, b*vbar, P: 4M; du: 2M; xbar: 4M;
#                 per period the boundary adjoint: ~7M
#   packed_fwd    alpha A: 2M^2; emission M; sum M; division M; log, add: 2
#   packed_bwd    the segment rebuild (2M^2 + 3M) + per site in reverse: u, c,
#                 alpha: 3M; <abar, alpha>: 2M; ubar: 3M; w: M; w A^T: 2M^2;
#                 dA += alpha_prev w: 2M^2; v*ubar, routed add: 2M
def flops_per_site(name: str, M: int) -> float:
    return {
        "smc_forward": 9 * M + (2 * M + 3) / 8,
        "smc_backward": 9 * M + (2 * M + 3) / 8 + 27 * M + 7 * M / 8,
        "packed_forward": 2 * M * M + 3 * M + 2,
        "packed_backward": (2 * M * M + 3 * M) + (4 * M * M + 12 * M),
    }[name]


def kernel_bytes(name: str, M: int, B: int, S: int, L: int) -> int:
    """Bytes `name` must move at (M, B, S, L), float32 tensors and int8
    observation rows (S, L): its inputs read once, its outputs written once."""
    f4 = 4 * B * S * M  # one (B, S, M) tensor: pi, alpha, a gradient
    ll = 4 * B * S  # ll, or its cotangent
    obs = S * L
    if name.startswith("smc"):
        par = 6 * 4 * B * M  # the six (B, M) parameter rows
        pstates = 4 * -(-L // SMC_PERIOD) * S * B * M
        return {
            "smc_forward": par + f4 + obs + ll + f4,
            "smc_forward_residuals": par + f4 + obs + ll + f4 + pstates,
            "smc_backward": par + obs + pstates + ll + f4 + 7 * f4,
        }[name]
    par = 4 * B * M * M + 2 * 4 * B * M  # A and the two emission rows
    ckpt = 4 * -(-L // PACKED_PERIOD) * B * S * M
    return {
        "packed_forward": par + f4 + obs + ll,
        "packed_forward_ckpt": par + f4 + obs + ll + ckpt,
        "packed_backward": par + obs + ckpt + ll + 4 * B * S * M * M + 3 * f4,
    }[name]


def kernel_bound(name: str, M: int, B: int, S: int, L: int,
                 live: float | None = None) -> tuple[float, str]:
    """(bound_ms, bound_by) of kernel `name` at (M, B, S, L); `live` counts
    the sites of all B * S instances that are not padding (default: all)."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; expected one of {KERNELS}")
    algo = {"smc_forward_residuals": "smc_forward",
            "packed_forward_ckpt": "packed_forward"}.get(name, name)
    sites = B * S * L if live is None else live
    return bound(flops_per_site(algo, M) * sites, kernel_bytes(name, M, B, S, L))


# The SMC' kernels' issue count.  Their bound above counts FLOPs and bytes;
# what limits them is the instructions a site's dependence chain issues
# (ops/smc.py's design note), so the bench also reads their share of the
# issue and shuffle ceilings.  States a lane at each M, as
# csrc/smc_common.cuh PHLASH_SMC_INSTANCES builds them:
SMC_SPL = {8: 2, 16: 4, 32: 2, 64: 4}
SMC_KERNELS = ("smc_forward", "smc_forward_residuals", "smc_backward")
# Two estimates, not counts (the SASS of their sequences was not counted on
# the path that runs): an IEEE division, the divisor's reciprocal once, then
# ~5 a quotient; libdevice logf without fast math, ~20.  The issue counts
# below, and the bench's sm_issue_peak_fraction_*, rest on them.
DIV_FIRST, DIV_NEXT = 3, 5
LOGF = 20


# Instructions one lane issues a site (all, and shuffles), counted from
# csrc/smc_common.cuh and the kernels' loops at SPL states a lane, G = M / SPL
# lanes an instance, lg = log2 G, R = lg - 2 doubling rounds:
#   scan_pair   the lane's own suffix and prefix 2 (SPL - 2) FADD, the lane
#               totals 2 (SPL - 1), three shuffles a scan (6 SHFL), their
#               selects and sums 6 FSEL + 4 FADD, per doubling round 2 SHFL +
#               2 FSEL + 4 FADD, the offsets 2 (SPL - 1) FADD:
#               6 SPL - 4 + 4 R FADD, 6 + 2 R SHFL, 6 + 2 R FSEL
#   advance     per state u a 1, v 3 (FMUL + 2 FFMA), the emission 2 FSEL +
#               FMUL, the padding select 1: 8; per site the code's three
#               compares
#   butterfly   SPL - 1 FADD, lg SHFL + lg FADD
#   smc_forward a site: scan_pair, advance, the code from shared memory
#               (load, bounds compare, select) 3; a period of 8 sites: the
#               butterfly, the clamp, SPL divisions by c, logf, the sum,
#               the loop 3; with residuals (B2) the state's store 5
#   smc_backward a site: the rebuild (scan_pair, advance); in reverse per
#               state yb 1, v 3, v yb 1, de0 / de1 2 + 2, vbar 3, db / dd /
#               dvv 3, vv vbar and b vbar 2 (17), scan_pair, per state du,
#               xbar 2, the padding select (4), the code's compares 3; a
#               period: the boundary state's load 3, the 8 codes 24, two
#               butterflies, the clamp, SPL divisions and SPL products, SPL
#               (2 FADD) and SPL divisions for ybar, the loop 3
# The count is the source's; nvcc may fuse or share some of it (the
# rebuild's v and emission factor recur in the reverse sweep), and
# tools/torch_sm_peak.py --sass counts the built kernels' loops for the
# cross-check in PERF.md.
def _smc_lane_counts(name: str, M: int) -> tuple[float, float]:
    spl = SMC_SPL[M]
    lg = (M // spl).bit_length() - 1
    R = lg - 2
    scan, scan_shfl = (6 * spl - 4 + 4 * R) + 2 * (6 + 2 * R), 6 + 2 * R
    advance = 8 * spl + 3
    bfly, bfly_shfl = spl - 1 + 2 * lg, lg
    div = DIV_FIRST + DIV_NEXT * spl
    if name in ("smc_forward", "smc_forward_residuals"):
        period = bfly + 1 + div + LOGF + 1 + 3 + (5 if name == "smc_forward_residuals" else 0)
        return scan + advance + 3 + period / 8, scan_shfl + bfly_shfl / 8
    reverse = 17 * spl + scan + 4 * spl + 3
    period = 3 + 24 + 2 * bfly + 1 + div + spl + 2 * spl + div + 3
    return scan + advance + reverse + period / 8, 2 * scan_shfl + 2 * bfly_shfl / 8


def issue_per_site(name: str, M: int) -> float:
    """Warp-instructions one instance (a group of G lanes, G / 32 of a warp)
    issues a site in SMC' kernel `name`."""
    if name not in SMC_KERNELS:
        raise ValueError(f"unknown SMC' kernel {name!r}; expected one of {SMC_KERNELS}")
    return _smc_lane_counts(name, M)[0] * (M // SMC_SPL[M]) / 32


def shuffles_per_site(name: str, M: int) -> float:
    "Warp-shuffles one instance issues a site in SMC' kernel `name`."
    if name not in SMC_KERNELS:
        raise ValueError(f"unknown SMC' kernel {name!r}; expected one of {SMC_KERNELS}")
    return _smc_lane_counts(name, M)[1] * (M // SMC_SPL[M]) / 32


def issue_share(ms: float, kernels: tuple, M: int, B: int, S: int, L: int,
                pipe: str = "issue") -> float:
    """The share of the issue ceiling (pipe "issue": all instructions over
    ISSUE_PEAK) or of the shuffle path ("shuffle": SHFL over SHFL_PEAK) that
    a call running the SMC' `kernels` once each over B * S * L sites in `ms`
    reached.  A share outside (0, 1] means a wrong count, and raises."""
    count, peak = {"issue": (issue_per_site, ISSUE_PEAK),
                   "shuffle": (shuffles_per_site, SHFL_PEAK)}[pipe]
    share = sum(count(k, M) for k in kernels) * B * S * L / peak / (ms * 1e-3)
    if not 0.0 < share <= 1.0:
        raise RuntimeError(f"{pipe} share {share} of {kernels} outside (0, 1]: the count is "
                           f"wrong (measured {ms} ms at M={M}, B={B}, S={S}, L={L})")
    return share


# Operations of one particle's assembly, counted from csrc/assembly_common.cuh
# (+, -, *, / and each libdevice exp / expm1 / log / log1p / sqrt count 1, so
# the count is a floor on the instructions): the coordinates' transforms
# (~13), the prior (10 K + 2 D + 6 over K rate groups), per finite interval
# ~231 (the grid point, texp_mean, the two sub-interval blocks of _expQ2 at
# ~70 each plus their occupancy update, the emissions, the diagonals, row 0
# and pi), ~100 for the open last interval, and the AFS term: per pair count 12 per finite interval + 6, the
# branch lengths' W product 2 (n - 1), the normalization 2 (n - 1) and
# R (4 (n - 1) + 3) for the transform and xlogy.
def assembly_flops(M: int, D: int, nm1: int, R: int) -> float:
    "Operations of A1 for one particle at M intervals, D coordinates, n - 1 AFS entries."
    K = D - 3
    ops = 13 + (10 * K + 2 * D + 6) + 231 * (M - 1) + 100
    if nm1:
        ops += nm1 * (12 * (M - 1) + 6 + 2 * nm1) + 2 * nm1 + R * (4 * nm1 + 3)
    return float(ops)


# Operations a gradient needs, in forward passes: the forward once and its
# reverse sweep at about twice that (the cheap-gradient principle's bound
# of 3 for +, -, * and /; a libdevice function's derivative reuses its
# value).  A2's own algorithm, D dual-number passes, does ~2.5 D of them:
# that is its cost, not the work of the function it computes.
GRAD_PASSES = 3


def assembly_bound(name: str, P: int, M: int, D: int, nm1: int = 0, R: int = 0,
                   elem: int = 4) -> tuple[float, str]:
    """(bound_ms, bound_by) of A1 ("assembly_forward") or A2
    ("assembly_backward") on P particles, in float32 (elem 4) or float64
    (elem 8).  Bytes: the coordinates, the pattern's index (int64), the AFS
    constants (afs, its transform, W) read once; A1 writes the (P, 7, M)
    leaves and the two (P,) terms, A2 reads their cotangents and writes the
    (P, D) gradient (the scratch buffer is the kernels' own and not
    counted).  Operations: A1 assembly_flops a particle; A2 GRAD_PASSES
    times that, what one reverse pass of A1 needs."""
    consts = 8 * M + elem * (nm1 + R * nm1 + nm1 * nm1)
    leaves = elem * (7 * P * M + 2 * P)
    coords = elem * P * D
    per = assembly_flops(M, D, nm1, R)
    if name == "assembly_forward":
        flops, nbytes = P * per, coords + consts + leaves
    elif name == "assembly_backward":
        flops = P * GRAD_PASSES * per
        nbytes = coords + consts + leaves + coords
    else:
        raise ValueError(f"unknown assembly kernel {name!r}")
    return bound(flops, nbytes, PEAK_FP32 if elem == 4 else PEAK_FP64)
