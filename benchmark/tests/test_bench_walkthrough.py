"""The walkthrough cell: its files, its frozen data, a CPU run through its check, its control.

walkthrough runs phlash_tpu_torch.fit as docs/torch_example.py calls it:
the contig read from an indexed BCF through two regions, a one-rank mesh,
a checkpoint file, calls of five and 32 particles.  Here the mesh is a
gloo world of one, the contig is cut by the data's `scale`, and the cloud
is 8 particles, so that the kernels' plain versions run it on the CPU.
"""

import importlib.util
import json

import numpy as np
import pytest
import torch.distributed as dist
from conftest import ROOT

from benchmark import cells, check, inputs, run, shapes
from benchmark.frozen import walkthrough
from benchmark.inputs import bcf
from benchmark.readings import variant
from benchmark.reference import fit as reference

NEW_METRICS = {"ckpt_ms_per_save", "ckpt_write_ms_per_save", "mesh_ms_per_call",
               "collectives_per_call"}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def small(scale: float = 0.1, particles: int = 8):
    "walkthrough at `scale` of its contig, `particles` particles, chunks of 500 + 100."
    cell = cells.load("walkthrough", ROOT)
    cell.config["data"]["scale"] = scale
    cell.config["fit"]["num_particles"] = particles
    cell.traffic["fit"]["chunk_size"] = 500
    return cell


@pytest.fixture
def own_group():
    "The entry's process group is destroyed after the test, as at the run's exit."
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_the_cell_reads_its_own_files():
    cell = cells.load("walkthrough", ROOT)
    opts = cell.fit_options()
    assert cell.entry.__name__ == "benchmark_entry_walkthrough"
    assert cell.config["data"]["input"] == "bcf" and cell.config["entry"] == "walkthrough"
    assert opts == {"kernel_backend": "smc", "num_particles": 32, "window_size": 100,
                    "num_workers": 1, "niter": 10_000_000, "elpd_cutoff": 10_000_000,
                    "progress": False, "overlap": 100, "chunk_size": 5000, "elpd_samples": None,
                    "steps_per_call": 5, "save_every": 50}
    assert cell.launches == check.launch_table("smc")
    assert set(cell.limits) == set(check.NUMBERS) and all(v > 0 for v in cell.limits.values())
    assert {m["name"] for m in cell.end_to_end} == {"iters_per_s", "setup_s"}
    assert set(cell.config["reduced"]) == {"niter", "elpd_cutoff"}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_new_readers_are_on_this_cell_only(workload):
    readers = set(cells.load(workload, ROOT).readers)
    if workload == "walkthrough":
        assert NEW_METRICS <= readers
        assert not readers & {"hmm_ms_per_iter", "hmm_roofline", "packed_roofline"}
    else:
        assert not readers & NEW_METRICS


def test_the_new_readers_read_nothing_without_a_fit(monkeypatch):
    "On a program that records no fit, or no save or mesh span, each new reader returns None."
    from phlash_tpu_torch import profiling

    cell = cells.load("walkthrough", ROOT)
    monkeypatch.setattr(profiling, "last_fit", lambda: None)
    assert all(cell.readers[m].read(None) is None for m in NEW_METRICS)
    monkeypatch.setattr(profiling, "last_fit", lambda: profiling.FitTrace())
    assert all(cell.readers[m].read(None) is None for m in NEW_METRICS)


def test_the_full_size_shapes_are_the_walkthroughs():
    """At full size the regions are the walkthrough's 12 Mb and 3 Mb, and
    fit's rules give 24 chunks of 5,000 + 100, S = 1 at niter 40, and 4 of
    6 held-out chunks an ELPD."""
    cell = cells.load("walkthrough", ROOT)
    data = cell.config["data"]
    span = data["windows"] * cell.config["fit"]["window_size"]
    (a, b), (c, d) = bcf.regions(span)
    assert f"chr1:{a}-{b}" == data["train_region"] and f"chr1:{c}-{d}" == data["held_out_region"]
    ins = inputs.make(cell.config, 2**31 + 3)
    try:
        sh = shapes.resolve(ins.ref, ins.ref_test, cell.fit_options(), cell.traffic)
    finally:
        ins.close()
    assert (sh.P, sh.S, sh.N, sh.N_test, sh.S_elpd, sh.M, sh.spc) == (32, 1, 24, 6, 4, 16, 5)


def _docs_example():
    spec = importlib.util.spec_from_file_location("torch_example",
                                                  ROOT / "docs" / "torch_example.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [1, 2**33 + 17])
def test_the_frozen_draw_and_writer_are_the_walkthroughs(tmp_path, seed):
    """The frozen copy writes the bytes of docs/torch_example.simulate_to_bcf
    (BCF and index) at the same seed, and the contigs the fit reads back
    through the port's reader equal Inputs.ref, which the drawn windows give."""
    L = 150_000
    _docs_example().simulate_to_bcf(str(tmp_path / "docs.bcf"), L, seed)
    het = walkthrough.simulate(L, seed)
    assert walkthrough.write_bcf(str(tmp_path / "frozen.bcf"), het, 100) == L * 100
    for suffix in ("", ".csi"):
        assert ((tmp_path / f"docs.bcf{suffix}").read_bytes()
                == (tmp_path / f"frozen.bcf{suffix}").read_bytes())
    data = cells.load("walkthrough", ROOT).config["data"]
    ins = bcf.make(data, seed, 100, {})
    try:
        for got, want in zip(ins.train + [ins.test], ins.ref + [ins.ref_test], strict=True):
            d = got.get_data(100)
            np.testing.assert_array_equal(d["het_matrix"], want.het)
            np.testing.assert_array_equal(d["afs"], want.afs)
            assert got.L == want.length
        assert np.concatenate([ins.ref[0].het, ins.ref_test.het], 1).tolist() == [het.tolist()]
    finally:
        ins.close()


def test_the_cell_passes_its_check_on_the_cpu(own_group):
    """The run's path on a gloo world of one and the plain versions:
    correct, the launches exactly smc.json's for calls of five; the entry's
    fits checkpoint (a save every 10 iterations here) and the writer's
    counters and spans are in the window's record."""
    from phlash_tpu_torch import checkpoint, profiling

    cell = small()
    cell.traffic["fit"]["save_every"] = 10
    out = run.run_cell(cell, 2**33 + 29, 8.0, False, device="cpu")
    gap = {k: c["value"] for k, c in out["checks"].items()}
    assert out["correct"] and gap["launch_mismatch"] == 0, gap
    rec = profiling.last_fit()
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    saves = rec.counts["ckpt_saves"]
    assert saves >= 1 and len(rec.named(checkpoint.WRITE_SPAN)) == saves
    assert rec.iterations // 10 <= saves <= rec.iterations // 10 + 1


def test_the_bf16_control_fails_the_limits():
    "The reference in bfloat16 in the program's place fails the cell's check by elpd_gap."
    cell = small()
    data = inputs.make(cell.config, 7)
    try:
        opts = cell.fit_options()
        sh = shapes.resolve(data.ref, data.ref_test, opts, cell.traffic)
        opts["minibatch_size"] = sh.S
        pb = reference.prepare(data.ref, opts, 7, "cpu", k=1, ref_test=data.ref_test)
    finally:
        data.close()
    ref = check.Reference(pb, reference, tuple(cell.limits))
    got = ref.numbers_of(variant(ref, None, "bf16"))
    correct, checks = check.judge(got, cell.limits, 0)
    assert not correct and checks["elpd_gap"]["value"] > checks["elpd_gap"]["limit"], checks
