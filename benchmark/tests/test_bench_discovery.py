"""The harness finds every configuration, traffic mix, metric reader and limit by name."""

import json
import shutil

import pytest
from conftest import ROOT

from benchmark import cells, check, run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(workload):
    cell = cells.load(workload, ROOT)
    assert cell.config["fit"]["window_size"] == 100
    assert set(cell.readers) == {m["name"] for m in BENCH["per_layer"]}
    assert all(callable(r.read) for r in cell.readers.values())
    assert cell.limits and set(cell.limits) <= set(check.NUMBERS)
    assert all(v > 0 for v in cell.limits.values())
    assert {m["name"] for m in cell.end_to_end} == {"iters_per_s", "setup_s"}


def test_benchmark_json_follows_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert set(json.loads((ROOT / c["file"]).read_text())["reduced"]) == set(c["reduced"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


PARTS = ("configs", "traffic", "metrics", "limits", "entries", "launches")


def test_new_files_add_a_cell_without_an_edit(tmp_path):
    "A mix, a metric reader and a cell's limits added as files in a copy are found."
    for part in PARTS:
        shutil.copytree(ROOT / "benchmark" / part, tmp_path / "benchmark" / part)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "diploid.throwaway", "config": "human_diploid",
                               "traffic": "throwaway", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "throwaway_count", "unit": "count", "better": "lower",
                               "source": "program_counter", "layer": "test",
                               "moves": "iters_per_s", "workloads": ["diploid.throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark" / "traffic" / "throwaway.json").write_text(json.dumps(
        {"fit": {"overlap": 50, "chunk_size": 800, "steps_per_call": 10}, "elpd_every": 10,
         "minibatch_size": 2, "trace_skip_calls": 1, "trace_seconds": 1.0}))
    (tmp_path / "benchmark" / "metrics" / "throwaway_count.py").write_text(
        "def read(run):\n    return 7.0\n")
    (tmp_path / "benchmark" / "limits" / "diploid.throwaway.json").write_text(
        json.dumps({"density_gap": 0.5}))
    cell = cells.load("diploid.throwaway", tmp_path)
    assert cell.fit_options()["chunk_size"] == 800 and cell.traffic["minibatch_size"] == 2
    assert cell.readers["throwaway_count"].read(None) == 7.0
    assert cell.limits == {"density_gap": 0.5}
    # the cells already there do not list the new metric
    assert "throwaway_count" not in cells.load("diploid.genome", tmp_path).readers


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        cells.load("no.such.cell", ROOT)


def test_a_packed_cell_of_calls_of_five_is_files_only(tmp_path, tiny):
    """A configuration on the packed kernels and a mix of calls of five (an
    ELPD every other call), added as files in a copy, run and pass their
    check on the CPU: the launches come from launches/packed.json and the
    mix's schedule, the entry and the input kind by name."""
    for part in PARTS:
        shutil.copytree(ROOT / "benchmark" / part, tmp_path / "benchmark" / part)
    bench = json.loads(json.dumps(BENCH))
    config = json.loads((ROOT / "benchmark" / "configs" / "human_diploid.json").read_text())
    config["fit"]["kernel_backend"] = "packed"
    (tmp_path / "benchmark" / "configs" / "human_diploid_packed.json").write_text(
        json.dumps(config))
    bench["configs"].append({"name": "human_diploid_packed", "source": "a test's",
                             "file": "benchmark/configs/human_diploid_packed.json",
                             "reduced": config["reduced"], "why": "a test's"})
    bench["workloads"].append({"name": "diploid.packed5", "config": "human_diploid_packed",
                               "traffic": "packed5", "chips": 1, "why": "a test's cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark" / "traffic" / "packed5.json").write_text(json.dumps(
        {"fit": {"overlap": 0, "chunk_size": 200, "steps_per_call": 5}, "elpd_every": 10,
         "minibatch_size": 1, "trace_skip_calls": 1, "trace_seconds": 0.5}))
    (tmp_path / "benchmark" / "limits" / "diploid.packed5.json").write_text(
        (ROOT / "benchmark" / "limits" / "diploid.genome.json").read_text())
    cell = cells.load("diploid.packed5", tmp_path)
    assert cell.launches["cpu"]["per_elpd"] == {"packed.forward_plain": 1,
                                                 "assembly.forward_plain": 1}
    cell.config["data"]["scale"] = 0.002
    cell.config["fit"].update(num_particles=8, num_workers=2)
    out = run.run_cell(cell, 99, 3.0, False, device="cpu")
    gap = {k: c["value"] for k, c in out["checks"].items()}
    assert out["correct"] and gap["launch_mismatch"] == 0, gap


@pytest.mark.parametrize("spc,calls,want", [
    (10, 3, (30, 3, {(10, True)})),
    (5, 4, (20, 2, {(5, True), (5, False)})),
    (20, 2, (40, 2, {(20, True)})),
])
def test_the_schedule_follows_the_mix(spc, calls, want):
    assert check.schedule(calls, spc, 10) == want


def test_the_warm_up_of_each_kind_of_call_counts_on_the_card():
    table = check.launch_table("smc")
    # calls of five: 20 iterations and 2 ELPDs, and two graphs (with and
    # without the ELPD), each warmed up by one eager iteration; one ELPD warm-up
    want = check.expected_launches(table, "cuda", 4, 5, 10)
    assert want["svgd"]["update_cuda"] == 22
    assert want["smc"]["forward_cuda"] == 2 * 22 + 2 * 3
    assert want["assembly"]["forward_cuda"] == 22 + 3
    plain_ran = {**want, "smc": {**want["smc"], "forward_plain": 1}}
    assert check.launch_mismatch(plain_ran, want) == 1
