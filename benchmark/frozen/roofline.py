"""Frozen copy of phlash_tpu_torch/roofline.py's counts and peaks.

The benchmark's yardstick: the float32 operations and bytes each hand
kernel's work needs, counted from its shapes, and the H100 SXM data-sheet
peaks they are held against.  Copied here so that a change to the program
cannot move the bound its kernels are measured against;
benchmark/tests/test_frozen.py holds every count equal to the program's
at the commit it was copied from, at the cells' shapes.  The issue counts
(`issue_per_site`, `issue_share`) are not copied: they rest on estimated
instruction costs, not on counts.
"""

from __future__ import annotations

PEAK_FP32 = 67e12  # FLOP/s: H100 SXM float32 outside the tensor cores (data sheet, 700 W)
PEAK_FP64 = 34e12  # FLOP/s: H100 SXM float64 outside the tensor cores (data sheet, 700 W)
PEAK_BYTES = 3.35e12  # B/s: H100 SXM HBM3
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
# value).  A2 is such a reverse pass: the forward, then each interval's
# local adjoint on width-3 dual numbers (about 4 forward evaluations of its
# blocks) and the scans' adjoints, some 5-6 passes of work in all.
GRAD_PASSES = 3


def assembly_bound(name: str, P: int, M: int, D: int, nm1: int = 0, R: int = 0,
                   elem: int = 4) -> tuple[float, str]:
    """(bound_ms, bound_by) of A1 ("assembly_forward") or A2
    ("assembly_backward") on P particles, in float32 (elem 4) or float64
    (elem 8).  Bytes: the coordinates, the pattern's index (int64), the AFS
    constants (afs, its transform, W) read once; A1 writes the (P, 7, M)
    leaves and the two (P,) terms, A2 reads their cotangents and writes the
    (P, D) gradient (the workspace in shared memory is the kernels' own and
    not counted).  Operations: A1 assembly_flops a particle; A2 GRAD_PASSES
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


# The SVGD update's kernels (ops/svgd.py), counted on the work itself:
#   svgd_distances  S1: a pair's squared distance, D coordinates at 3
#                   operations (-, *, +); reads x and g, writes the triangle,
#                   x^T and the masked g^T
#   svgd_bandwidth  S2: one comparison an element of the triangle (a selection
#                   reads each element once at least); reads the triangle,
#                   writes h
#   svgd_update     S3: for B rows over P columns, the distance (3 D), K (an
#                   exp and a division, 2) and the two sums (2 D and 3 D);
#                   amsgrad ~15 an entry; reads x, x^T, g^T, h and the three
#                   moments, writes the particles, the three moments and the count
# in the cloud's dtype: float32 against PEAK_FP32, float64 against PEAK_FP64.
SVGD_KERNELS = ("svgd_distances", "svgd_bandwidth", "svgd_update")
AMSGRAD_FLOPS = 15


def svgd_bound(name: str, P: int, D: int, B: int | None = None,
               elem: int = 4) -> tuple[float, str]:
    """(bound_ms, bound_by) of S1 ("svgd_distances"), S2 ("svgd_bandwidth")
    or S3 ("svgd_update") on a cloud of P particles of D coordinates, S3
    moving B rows (all P by default), in float32 (elem 4) or float64 (8)."""
    B = P if B is None else B
    m = P * (P - 1) // 2
    if name == "svgd_distances":
        flops, nbytes = 3 * D * m, elem * (2 * P * D + m + 2 * P * D)
    elif name == "svgd_bandwidth":
        flops, nbytes = m, elem * (m + 1)
    elif name == "svgd_update":
        flops = B * P * (8 * D + 2) + AMSGRAD_FLOPS * B * D
        nbytes = elem * (3 * P * D + 1 + 3 * B * D + 4 * B * D) + 16
    else:
        raise ValueError(f"unknown SVGD kernel {name!r}")
    return bound(flops, nbytes, PEAK_FP32 if elem == 4 else PEAK_FP64)
