"""The row split (ops/split.py) and the counter registry (profiling.py) on the CPU.

Both HMM kernel pairs bind one split: `segment_plan` of ops/smc.py and of
ops/packed.py is split.plan at each pair's warps and targets, and their
`forward_segmented` / `backward_segmented` are split's plain renderings at
each pair's period step (test_torch_smc.py and test_torch_packed.py hold
those to the unsplit plain versions).  Here: the plans both bindings give
at the H100's 132 SMs, pinned; the counters' keys, which the benchmark's
readers and chip_smoke.py's expected counts read; the registry's graph
capture and replay cycle; the keys of a fit's record; and the direction of
the imports (the spans-and-counters layer names no kernel module).
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from phlash_tpu_torch import mcmc, profiling  # noqa: E402
from phlash_tpu_torch.data import RawContig  # noqa: E402
from phlash_tpu_torch.ops import assembly, packed, peak, smc, split  # noqa: E402
from phlash_tpu_torch.ops import svgd as ops_svgd  # noqa: E402
from phlash_tpu_torch.parallel import mesh  # noqa: E402
from phlash_tpu_torch.svgd import median_bandwidth  # noqa: E402

PKG = Path(__file__).resolve().parent.parent / "phlash_tpu_torch"
SMS = 132  # the H100 SXM's SMs
# the warps an SM the split SMC' adjoint's kernels hold on the H100 at every M
# (smc.resident_warps, the library's occupancy figure)
RESIDENT = 16

# (backend, direction, (B, S, L), (K, P)) at 132 SMs and M = 16, the SMC'
# adjoint at RESIDENT warps an SM; the packed rows' L is the kernel's padded
# row (a multiple of 8)
GOLDEN = [
    ("smc", "forward", (500, 1, 94_500), (33, 368)),
    ("smc", "forward", (500, 5, 94_500), (6, 1984)),
    ("smc", "forward", (500, 5, 20_000), (6, 432)),
    ("smc", "forward", (500, 5, 600), (1, 75)),
    ("smc", "forward", (2500, 1, 94_000), (6, 1968)),
    ("smc", "forward", (1, 1, 1_000_000), (460, 272)),
    ("smc", "adjoint", (500, 1, 94_500), (33, 368)),
    ("smc", "adjoint", (500, 5, 94_500), (6, 1984)),
    ("smc", "adjoint", (500, 5, 20_000), (6, 432)),
    ("smc", "adjoint", (500, 5, 600), (1, 75)),
    ("smc", "adjoint", (2500, 1, 94_000), (6, 1968)),
    ("packed", "forward", (500, 1, 94_000), (16, 736)),
    ("packed", "forward", (500, 4, 94_000), (4, 2944)),
    ("packed", "forward", (500, 5, 2_000), (1, 250)),
    ("packed", "forward", (500, 5, 20_000), (3, 848)),
    ("packed", "adjoint", (500, 1, 94_000), (6, 1968)),
    ("packed", "adjoint", (500, 4, 94_000), (1, 11750)),
    ("packed", "adjoint", (500, 5, 2_000), (1, 250)),
    ("packed", "adjoint", (1, 1, 1_000_000), (391, 320)),
]


@pytest.mark.parametrize("backend,direction,shape,want", GOLDEN,
                         ids=[f"{b}-{d}-{'x'.join(map(str, s))}" for b, d, s, _ in GOLDEN])
def test_segment_plan_golden_table(backend, direction, shape, want):
    "Each backend's segment_plan gives the pinned Plan; the split module's Plan is both's."
    if backend == "smc":
        got = smc.segment_plan(*shape, 16, SMS, direction, RESIDENT)
    else:
        got = packed.segment_plan(*shape, SMS, direction)
    assert got == split.Plan(*want) and smc.Plan is packed.Plan is split.Plan


@pytest.mark.parametrize("M,direction,want", [(32, "forward", (8, 1488)),
                                              (64, "adjoint", (8, 1488))])
def test_segment_plan_follows_the_states_per_lane(M, direction, want):
    "The SMC' plan at M = 32 / 64 (2 / 4 states a lane) on one genome's row."
    assert smc.segment_plan(500, 1, 94_500, M, SMS, direction, RESIDENT) == split.Plan(*want)


# the SMC' adjoint's plans at 8 warps an SM, the residency of kernels that
# keep their period cache in registers (255 registers a thread)
AT_8_WARPS = {(500, 1, 94_500, 16): (16, 752), (500, 5, 94_500, 16): (3, 3952),
              (500, 5, 20_000, 16): (3, 848), (500, 5, 600, 16): (1, 75),
              (2500, 1, 94_000, 16): (3, 3920), (500, 1, 94_500, 64): (4, 2960)}


@pytest.mark.parametrize("resident", [4, 8, 12, 16, 24])
def test_the_adjoint_plan_never_exceeds_the_resident_warps(resident):
    """The adjoint's K brings the unsplit grid to at most as many warps an SM
    as its kernel holds (`resident`) and as its target; at 8 warps an SM the
    plans are those of kernels held to 8, at 16 or more those of the target
    alone.  The forward's plan ignores the figure."""
    target = smc.TARGET_WARPS_PER_SM["adjoint"]
    for (B, S, L, M), at8 in AT_8_WARPS.items():
        plan = smc.segment_plan(B, S, L, M, SMS, "adjoint", resident)
        warps = smc.launch_geometry(B, S, M, smc.STATES_PER_LANE[M], smc.INSTANCES_PER_BLOCK)
        assert plan.K == 1 or plan.K * warps["warps"] <= min(target, resident) * SMS
        if resident == 8:
            assert plan == split.Plan(*at8), (B, S, L, M)
        if resident >= target:
            assert plan == smc.segment_plan(B, S, L, M, SMS, "adjoint", target)
        assert (smc.segment_plan(B, S, L, M, SMS, "forward", resident)
                == smc.segment_plan(B, S, L, M, SMS, "forward"))


@pytest.mark.parametrize("B,S,L,shared", [(500, 1, 94_000, True), (500, 5, 94_000, True),
                                           (32, 1, 5_000, False), (500, 1, 30_000, False)])
def test_the_split_adjoint_keeps_its_cache_in_registers_where_they_hold_its_warps(B, S, L,
                                                                               shared):
    """At segment_plan's K, the split adjoint keeps its period cache in
    shared memory where its warps exceed what the register-cache kernels
    hold (8 warps an SM at M = 16 on the H100): one genome's rows and the
    cohort's (K = 32, 6); in registers at the walkthrough's B = 32 (K = 2)
    and at shorter rows that split less (K = 14 of 63 warps)."""
    K = smc.segment_plan(B, S, L, 16, SMS, "adjoint", RESIDENT).K
    assert K > 1 and smc.shared_cache(B, S, 16, K, SMS, 8) is shared


def test_the_split_adjoint_tallies_its_launches_and_warps(monkeypatch):
    """backward_cuda adds each split launch and its warps (K x the unsplit
    grid's) to the fit-record tallies SPLIT_COUNTS, and nothing for an
    unsplit launch: at one diploid's rows on 132 SMs, K = 32 of 63 warps,
    15.3 warps an SM.  The card is stood in for: its checks, SM count,
    residency and launch."""
    monkeypatch.setattr(smc, "require_cuda", lambda floats, ints8=(): torch.device("cpu"))
    monkeypatch.setattr(smc, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(smc, "resident_warps", lambda M, dev, shared=True: RESIDENT)
    plans = []
    monkeypatch.setattr(smc, "backward_launch",
                        lambda params, obs, pst, gbar, abar0, plan, live=None:
                        plans.append(plan) or ((abar0,) * 6, abar0))
    smc.split_tally.reset()
    smc.reset_counts()
    for S, L in ((1, 93_999), (5, 600)):
        abar0 = torch.zeros(500, S, 16)
        smc.backward_cuda(None, torch.zeros(S, L, dtype=torch.int8), None, None, abar0)
    assert [p.K for p in plans] == [32, 1] and smc.counts()["backward_cuda"] == 2
    got = smc.split_tally.counts()
    assert got == {"smc_adjoint_split_launches": 1, "smc_adjoint_split_warps": 32 * 63}
    assert abs(got["smc_adjoint_split_warps"] / got["smc_adjoint_split_launches"] / SMS
               - 15.27) < 0.01
    smc.split_tally.reset()
    smc.reset_counts()


COUNT_KEYS = {
    "smc": {"forward_cuda", "forward_cuda_residuals", "backward_cuda", "forward_plain",
            "backward_plain"},
    "packed": {"forward_cuda", "backward_cuda", "forward_plain", "backward_plain"},
    "assembly": {"forward_cuda", "backward_cuda", "forward_plain", "backward_plain"},
    "svgd": {"distances_cuda", "bandwidth_cuda", "update_cuda", "bandwidth_plain",
             "direction_plain", "amsgrad_plain"},
    "peak": {"run_cuda"},
}
MODULES = {"smc": smc, "packed": packed, "assembly": assembly, "svgd": ops_svgd, "peak": peak}


@pytest.mark.parametrize("name", sorted(COUNT_KEYS))
def test_counts_keep_their_keys(name):
    """counts() of each counting module has its pinned keys, zeros after
    reset_counts, and add_counts adds a counts() dict to it."""
    mod = MODULES[name]
    mod.reset_counts()
    c = mod.counts()
    assert set(c) == COUNT_KEYS[name] and not any(c.values())
    mod.add_counts(dict.fromkeys(c, 2))
    mod.add_counts(dict.fromkeys(c, 1))
    assert mod.counts() == dict.fromkeys(c, 3)
    mod.reset_counts()


def test_the_work_tally_keeps_its_keys():
    packed.reset_work()
    assert packed.work() == {"packed_sites": 0, "packed_ckpt_bytes": 0}


def _run_some_ops():
    "What a step's wrappers count on the CPU: plain B1-B5, S2's plain bandwidth, two collectives."
    g = torch.Generator().manual_seed(0)
    params = tuple(torch.rand(2, 8, generator=g) for _ in range(6))
    pi = torch.full((2, 3, 8), 1 / 8)
    obs = torch.zeros(3, 16, dtype=torch.int8)
    ll, alpha, pst = smc.forward(params, pi, obs, True)
    smc.backward(params, obs, pst, torch.ones_like(ll), torch.zeros_like(alpha))
    A = torch.eye(16)[None].expand(2, 16, 16).contiguous()
    e = torch.full((2, 16), 0.5)
    ll, ck = packed.forward(A, e, e, torch.full((2, 3, 16), 1 / 16), obs, 8, True)
    packed.backward(A, e, e, obs, ck, torch.ones_like(ll), 8)
    median_bandwidth(torch.rand(4, 4, generator=g), 4)
    mesh._count("all_reduce/world/density", torch.zeros(3))
    mesh._count("all_gather/p/cloud", torch.zeros(2, 5, dtype=torch.float64))


def test_a_capture_is_taken_back_and_added_at_each_replay(monkeypatch):
    """training.Caller's cycle: snapshot before the capture, take the
    capture's share back after it, add it at each replay.  The counts are
    what per-module arithmetic gives (before + k x the capture's change,
    each module's counts() and packed's work()), and a mesh's collectives
    leave the capture's span, and the span around a replay gets them."""
    monkeypatch.setattr(profiling, "_open", profiling.FitTrace())
    monkeypatch.setattr(profiling, "_autograd_profiler", torch.autograd.profiler)
    mods = {"smc": smc, "packed": packed, "assembly": assembly, "svgd": ops_svgd, "mesh": mesh}

    def read():
        return {**{k: m.counts() for k, m in mods.items()}, "work": packed.work()}

    for m in mods.values():
        m.reset_counts()
    packed.reset_work()
    with profiling.Span("phlash.fit") as root:
        _run_some_ops()  # the warm-up: stays counted
        before = read()
        snap = profiling.snapshot()
        with profiling.Span("phlash.capture") as cap:
            _run_some_ops()
            _run_some_ops()
        after = read()
        change = {k: {n: v - before[k].get(n, 0) for n, v in c.items()} for k, c in after.items()}
        share = profiling.since(snap)
        assert {t for t, _ in share} == {smc.tally, packed.tally, packed.work_tally,
                                         ops_svgd.tally, mesh.tally}
        profiling.replay(share, -1)
        assert read() == {k: {n: before[k].get(n, 0) for n in c} for k, c in after.items()}
        for k in (1, 2, 3):
            with profiling.Span("phlash.call.launch") as launch:
                profiling.replay(share)
            assert read() == {m: {n: before[m].get(n, 0) + k * v for n, v in c.items()}
                              for m, c in change.items()}
            assert launch.counts == {"collectives": 4}
        assert change["mesh"]["all_gather/p/cloud/bytes"] == 2 * 80
    assert cap.counts == {"collectives": 4}
    assert root.counts == {"collectives": 2 + 3 * 4}  # the warm-up's and the replays'


FIT = dict(device="cpu", num_particles=4, chunk_size=20, minibatch_size=1, progress=False, seed=3,
           niter=2, steps_per_call=1)
RECORD_KEYS = {"smc_segments", "smc_segments_resolved", "smc_fix_sites", "smc_split_sites",
               "smc_trimmed_sites", "smc_row_sites", "smc_adjoint_split_launches",
               "smc_adjoint_split_warps",
               "packed_segments", "packed_segments_resolved", "packed_fix_sites",
               "packed_split_sites", "packed_sites", "packed_ckpt_bytes",
               "ckpt_saves", "ckpt_bytes", "ckpt_waits"}


@pytest.mark.parametrize("backend,overlap", [("smc", 4), ("packed", 0)])
def test_a_fits_record_has_the_counter_keys(backend, overlap):
    """FitTrace.counts after a CPU fit: the four device counts of each
    split pair, the SMC' pair's two live-end counts and its split adjoint's
    two tallies, the packed work tallies and the checkpoint writer's
    counters, whatever the backend
    (zeros where unused: nothing splits or trims on the card from the CPU,
    and this fit saves no checkpoint)."""
    het = np.random.default_rng(0).integers(0, 2, size=(1, 200)).astype(np.int8)
    contig = RawContig(het_matrix=het, afs=np.array([4.0, 2.0, 1.0]), window_size=100)
    mcmc.fit([contig], kernel_backend=backend, overlap=overlap, **FIT)
    counts = profiling.last_fit().counts
    assert set(counts) == RECORD_KEYS
    assert not any(counts[k] for k in RECORD_KEYS - {"packed_sites", "packed_ckpt_bytes"})
    packed_ran = backend == "packed"
    assert (counts["packed_sites"] > 0) == (counts["packed_ckpt_bytes"] > 0) == packed_ran


def _imports(path: Path) -> set:
    "Every module a file imports, at any depth, `from a import b` as a and a.b."
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


@pytest.mark.parametrize("path,banned", [
    ("profiling.py", "phlash_tpu_torch.ops"),
    ("training.py", "phlash_tpu_torch.ops"),
    ("ops/packed.py", "phlash_tpu_torch.ops.smc"),
])
def test_the_imports_point_down(path, banned):
    """profiling.py (the spans and counters) and training.py import no kernel
    module, and the dense-transition pair takes nothing from the SMC' pair."""
    bad = {m for m in _imports(PKG / path) if m == banned or m.startswith(banned + ".")}
    assert not bad, bad
