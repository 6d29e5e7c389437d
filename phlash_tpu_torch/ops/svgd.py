"""The SVGD update of one iteration: distances, bandwidth, RBF direction and amsgrad.

`svgd.SVGD.step` takes the cloud's log-density gradients to the next state.
The plain version is the tensor code the port has always run
(svgd.update_plain: the finiteness mask, `svgd_direction` with the sort in
`median_bandwidth`, `AMSGrad.update`); on the card three hand kernels
replace it
(csrc/svgd.cu):

    S1 distances_cuda  particles x (P, D), gradients g (P, D) -> the strict
                       lower triangle of squared distances (P (P - 1) / 2,)
                       row-major, x^T and g^T (D, P) with non-finite
                       gradients 0, and the selection's first digit
    S2 bandwidth_cuda  that triangle -> h (0-d), bitwise median_bandwidth's
    S3 update_cuda     the direction of rows `rows` over every particle and
                       amsgrad: particles, mu, nu, nu_max (B, D), count + 1

in the cloud's dtype (float32, or float64 under double_precision_params).
`step_cuda` runs the three.  Nothing reads a value back to the host: h and
the count stay on the card, so training.Caller's CUDA graph captures the
update with the rest of the step.

Dispatch (svgd.SVGD.step): a CUDA tensor launches the kernels (or raises),
a CPU tensor takes the plain version; there is no other path and no
fallback.  Every wrapper counts what it ran in `tally` (the plain
versions in svgd.py add to it too; `counts`, `reset_counts`,
`add_counts`); a CUDA graph replay, which calls no wrapper, adds what its
capture counted (training.Caller does).

Kernel design note (csrc/svgd.cu).
* Replaces: phlash_tpu/svgd.py:32-76, the exact bitwise median selection
  (`_kth_smallest_bits`, `_offdiag_median_select`) that phlash_tpu's
  median_bandwidth takes on the accelerator (svgd.py:104-108) because the
  full sort "was the largest non-kernel term of the SVGD step"; and
  svgd.py:79-130 (median_bandwidth, svgd_direction) with the optax amsgrad
  update that XLA fuses after them in phlash_tpu's jitted step
  (mcmc.py:259).  The port ran them as ~50 ATen kernels an iteration, one
  a full torch.sort of the P^2 - P distances.
* What bounds it on the H100: latency, not work.  At P = 500, D = 18 the
  update is ~40 MFLOP and ~1 MB (under a microsecond at the data-sheet
  rates: roofline.svgd_bound); the plain version's time is its ~50
  launches and the sort, and the kernels' is the chain of dependent steps
  that an exact median needs (each digit of the selection waits for the
  count of the one before).
* What the design does about it: three launches, each pass of the
  selection over the whole triangle spread over many blocks, and the work
  after a pass done by the last block to finish (a ticket counter), so
  that no launch waits on a grid-wide barrier.  The selection is an exact
  radix select on the float bit patterns (non-negative IEEE floats order as
  their bits), 13-bit digits from the top (3 passes in float32, 5 in
  float64): S1 computes the triangle a thread a pair, from the cloud in
  shared memory, and histograms its first digit; its last block picks the
  bin that holds the lower middle rank.  S2's 64 blocks histogram the
  second digit of the elements in that bin and bucket them by it; S2's last
  block picks the second digit, copies that bucket (tens of elements
  unless the cloud is nearly degenerate) into shared memory and selects the
  rest there, then the upper middle rank (a duplicate, or the least value
  above).  Then the plain version's own arithmetic on the card (sqrt,
  mean, square, ATen's reciprocal of log P, the floor): h is the sort's,
  bit for bit, with ties, duplicates and a degenerate cloud alike, and
  deterministic (integer counts, exact minima).  S3 a block a row, lanes
  on columns: K[r, j] = exp(-sq / h) in registers (never in device
  memory), the two (P, P) x (P, D) products as sums over the lane's
  columns, a butterfly over the lanes and the warps in order (no float
  atomics: graphed equals eager bitwise), then amsgrad in the cloud's
  dtype.  The distances, K and the sums are in double whatever the dtype
  (the card's float64 rate costs nothing at this size), and the repulsion
  summed as K (x_j - x_r) does not cancel as K x - rowsum(K) x_r does:
  coincident particles repel exactly 0.  S3's shared memory is 9 D
  doubles: any P runs, and a D whose row exceeds the card's opt-in limit
  raises ValueError before any launch (`kernel_geometry`).  S1 and S2 sum
  their histograms and take their tickets in a workspace of each call's
  own, which the C entry point zeroes on the launch's stream (a memset
  node under graph capture): calls on any streams are independent.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from phlash_tpu_torch import profiling
from phlash_tpu_torch.ops.build import check, load_library, ptr, stream

DTYPES = (torch.float32, torch.float64)
RADIX = 13  # bits of each digit of S2's selection (csrc/svgd.cu's RADIX); S1 makes the first
SELECT_BLOCKS = 64  # S2's blocks (csrc/svgd.cu's SELECT_BLOCKS), each with its bins' offsets
# the CUDA wrappers' launches and the plain versions' calls (svgd.py's
# median_bandwidth, svgd_direction and AMSGrad.update add theirs)
tally = profiling.Tally(("distances_cuda", "bandwidth_cuda", "update_cuda", "bandwidth_plain",
                         "direction_plain", "amsgrad_plain"))
counts, reset_counts, add_counts = tally.counts, tally.reset, tally.add_counts


def pairs(P: int) -> int:
    "The strict lower triangle's size: S1's output, S2's input."
    return P * (P - 1) // 2


def inv_log(P: int, dtype) -> float:
    """1 / log(P) as ATen computes it on the card for `t / math.log(P)`: the
    reciprocal of the divisor in the tensor's dtype, by which it multiplies."""
    if dtype == torch.float32:
        return float(np.float32(1.0) / np.float32(math.log(P)))
    return 1.0 / math.log(P)


def _check_cloud(x: torch.Tensor, g: torch.Tensor | None = None) -> tuple[int, int]:
    "(P, D) of a cloud the kernels take, or ValueError."
    if x.device.type != "cuda":
        raise ValueError(f"the SVGD kernels need CUDA tensors, got {x.device}")
    if x.dtype not in DTYPES or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"particles must be contiguous float32 or float64 (P, D), got "
                         f"{x.dtype} {tuple(x.shape)}")
    P, D = x.shape
    if P < 2 or pairs(P) >= 2**31 or P * D >= 2**31:
        raise ValueError(f"the SVGD kernels take 2 <= P with P (P - 1) / 2 and P D below 2^31, "
                         f"got P={P}, D={D}")
    if g is not None and (g.shape != x.shape or g.dtype != x.dtype or g.device != x.device
                          or not g.is_contiguous()):
        raise ValueError(f"gradients must be contiguous {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    return P, D


def _rows(rows: slice, P: int) -> tuple[int, int]:
    "(first row, rows) of a slice of the cloud: S3 moves a contiguous block."
    r = range(P)[rows]
    if r.step != 1 or len(r) == 0:
        raise ValueError(f"rows must be a non-empty contiguous slice of the {P} particles, "
                         f"got {rows}")
    return r.start, len(r)


def kernel_geometry(P: int, D: int) -> dict:
    """How S1-S3 lay the work out on the current card at (P, D), as the
    built library reports it: S1's threads a block, S2's threads a block
    and blocks, how many candidates S2's last block holds in shared memory
    in each dtype, S3's threads a block (a block a row) and shared bytes a
    block (the row and the warps' partial sums, in double whatever the
    cloud's dtype), beside the card's opt-in limit; `fits` False where S3's
    shared memory exceeds it (update_cuda raises ValueError then)."""
    lib = load_library().lib
    out = (ctypes.c_longlong * 8)()
    status = lib.phlash_svgd_geometry(P, D, out)
    keys = ("distance_threads_per_block", "bandwidth_threads_per_block", "bandwidth_blocks",
            "bandwidth_candidates_float32", "bandwidth_candidates_float64",
            "update_threads_per_block", "update_shared_bytes_per_block", "shared_bytes_limit")
    return dict(zip(keys, out), fits=status == 0)


@functools.lru_cache(maxsize=64)
def _geometry_on(dev: torch.device, P: int, D: int) -> dict:
    with torch.cuda.device(dev):
        return kernel_geometry(P, D)


def _workspace(dev: torch.device) -> torch.Tensor:
    "A launch's histogram and ticket (S1, S2), which the C entry point zeroes."
    return torch.empty((1 << RADIX) + 1, dtype=torch.int32, device=dev)


def distances_cuda(x: torch.Tensor, g: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """S1: (the triangle of squared distances (P (P - 1) / 2,), x^T (D, P),
    the masked gradients transposed (D, P), the selection's state after its
    first digit (3,) int64: prefix, rank of the lower middle element among
    the elements that share it, their count), for S2 and S3."""
    P, D = _check_cloud(x, g)
    lib = load_library()
    tri = torch.empty(pairs(P), dtype=x.dtype, device=x.device)
    xt = torch.empty(D, P, dtype=x.dtype, device=x.device)
    gt = torch.empty(D, P, dtype=x.dtype, device=x.device)
    sel = torch.empty(3, dtype=torch.int64, device=x.device)
    ws = _workspace(x.device)
    with torch.cuda.device(x.device):
        err = lib.lib.phlash_svgd_distances(x.element_size(), ptr(x), ptr(g), P, D, ptr(tri),
                                            ptr(xt), ptr(gt), ptr(sel), ptr(ws),
                                            stream(x.device))
    check(lib, err, "svgd_distances launch")
    tally.add("distances_cuda")
    return tri, xt, gt, sel


def bandwidth_cuda(tri: torch.Tensor, sel: torch.Tensor, P: int) -> torch.Tensor:
    """S2: h (0-d, on the card) from S1's triangle of a cloud of P particles
    and S1's selection state `sel`."""
    if tri.device.type != "cuda":
        raise ValueError(f"the SVGD kernels need CUDA tensors, got {tri.device}")
    if (tri.dtype not in DTYPES or P < 2 or tri.shape != (pairs(P),) or not tri.is_contiguous()
            or pairs(P) >= 2**31):
        raise ValueError(f"the triangle must be contiguous float32 or float64 ({pairs(P)},) "
                         f"for P={P}, got {tri.dtype} {tuple(tri.shape)}")
    if sel.shape != (3,) or sel.dtype != torch.int64 or sel.device != tri.device:
        raise ValueError(f"the selection state must be S1's (3,) int64 on {tri.device}")
    lib = load_library()
    work = torch.empty_like(tri)  # each block's candidates, in its slice's place
    offs = torch.empty(SELECT_BLOCKS * ((1 << RADIX) + 1), dtype=torch.int32, device=tri.device)
    ws = _workspace(tri.device)
    h = torch.empty((), dtype=tri.dtype, device=tri.device)
    with torch.cuda.device(tri.device):
        err = lib.lib.phlash_svgd_bandwidth(tri.element_size(), ptr(tri), ptr(sel), P,
                                            inv_log(P, tri.dtype), ptr(work), ptr(offs),
                                            ptr(ws), ptr(h), stream(tri.device))
    check(lib, err, "svgd_bandwidth launch")
    tally.add("bandwidth_cuda")
    return h


def update_cuda(x: torch.Tensor, xt: torch.Tensor, gt: torch.Tensor, h: torch.Tensor,
                rows: slice, mu, nu, nu_max, count, optimizer) -> tuple[torch.Tensor, ...]:
    """S3: (particles, mu, nu, nu_max, count) after one amsgrad step along
    the direction of rows `rows` (a contiguous slice of the cloud; mu, nu,
    nu_max are that block's (B, D)) from S1's x^T and masked g^T and S2's
    h; `optimizer` gives learning_rate, b1, b2 and eps (svgd.AMSGrad)."""
    P, D = _check_cloud(x)
    row0, B = _rows(rows, P)
    for t in (xt, gt):
        if (t.shape != (D, P) or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"x^T and g^T must be contiguous {x.dtype} ({D}, {P}) on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    for t in (mu, nu, nu_max):
        if (tuple(t.shape) != (B, D) or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"the moments must be contiguous {x.dtype} ({B}, {D}) on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if h.shape != () or h.dtype != x.dtype or h.device != x.device:
        raise ValueError(f"h must be a 0-d {x.dtype} tensor on {x.device}")
    if count.shape != () or count.dtype != torch.int64 or count.device != x.device:
        raise ValueError(f"the count must be a 0-d int64 tensor on {x.device}")
    geo = _geometry_on(x.device, P, D)
    if not geo["fits"]:
        raise ValueError(f"svgd_update at P={P}, D={D} needs "
                         f"{geo['update_shared_bytes_per_block']} bytes of shared memory a "
                         f"block, above this card's {geo['shared_bytes_limit']}")
    lib = load_library()
    outs = [torch.empty_like(mu) for _ in range(4)]
    count_out = torch.empty_like(count)
    with torch.cuda.device(x.device):
        err = lib.lib.phlash_svgd_update(
            x.element_size(), ptr(x), ptr(xt), ptr(gt), ptr(h), P, D, row0, B, ptr(mu), ptr(nu),
            ptr(nu_max), ptr(count), float(optimizer.learning_rate), float(optimizer.b1),
            float(optimizer.b2), float(optimizer.eps), *map(ptr, outs),
            ptr(count_out), stream(x.device))
    check(lib, err, "svgd_update launch")
    tally.add("update_cuda")
    return (*outs, count_out)


def step_cuda(x: torch.Tensor, g: torch.Tensor, rows: slice, opt_state, optimizer):
    """S1, S2, S3: svgd.update_plain on the card, the state tensors
    (particles, mu, nu, nu_max, count) of rows `rows` after one SVGD +
    amsgrad step from every particle x and every gradient g; opt_state
    holds that block's moments and the count.
    A gathered cloud (parallel/mesh.gather_cloud) arrives as column slices
    of one tensor: they are copied contiguous first."""
    x, g = x.contiguous(), g.contiguous()
    tri, xt, gt, sel = distances_cuda(x, g)
    h = bandwidth_cuda(tri, sel, x.shape[0])
    o = opt_state
    return update_cuda(x, xt, gt, h, rows, o.mu, o.nu, o.nu_max, o.count, optimizer)
