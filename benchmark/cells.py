"""Find a cell's configuration, traffic mix and per-layer metric readers by name.

Everything the harness runs is named in BENCHMARK.json at the checkout's
root: a workload names its configuration and traffic mix, and a
configuration names its file.  A traffic mix `<mix>` is
benchmark/traffic/<mix>.json, a per-layer metric `<metric>` is read by
benchmark/metrics/<metric>.py (a module with `read(run) -> float | None`),
and a cell's limits on the numbers its check compares are
benchmark/limits/<cell>.json.  The configuration names the entry the
window drives (benchmark/entries/<entry>.py, "fit" where it names none)
and its input kind (benchmark/inputs/<kind>.py); its fit options' and the
mix's kernel_backend ("smc" where neither names one) names the launch
table the check holds the counters to (benchmark/launches/<backend>.json).
So a later configuration, mix or metric is new files and entries, and no
edit of the harness.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    end_to_end: list[dict]  # BENCHMARK.json's entries this cell reports
    per_layer: list[dict]
    limits: dict  # number compared -> its limit
    entry: ModuleType  # benchmark/entries/<entry>.py: call(...) and observe(frame)
    launches: dict  # benchmark/launches/<backend>.json
    readers: dict[str, ModuleType] = field(default_factory=dict)  # per-layer name -> reader

    def fit_options(self) -> dict:
        "The keyword options of phlash_tpu_torch.fit: the configuration's, then the mix's."
        return {**self.config["fit"], **self.traffic["fit"]}


def load_module(path: Path, name: str) -> ModuleType:
    "A module from its file, by path (readers are files, not a package)."
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load(workload: str, root: Path = ROOT) -> Cell:
    "The cell `workload` of root/BENCHMARK.json, with its files read and its readers loaded."
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload) and m["moves"] in reported]
    readers = {m["name"]: load_module(root / "benchmark" / "metrics" / f"{m['name']}.py",
                                      f"benchmark_metric_{m['name']}")
               for m in per_layer}
    limits = json.loads((root / "benchmark" / "limits" / f"{workload}.json").read_text())
    entry_name = config.get("entry", "fit")
    entry = load_module(root / "benchmark" / "entries" / f"{entry_name}.py",
                        f"benchmark_entry_{entry_name}")
    backend = {**config["fit"], **traffic["fit"]}.get("kernel_backend") or "smc"
    launches = json.loads((root / "benchmark" / "launches" / f"{backend}.json").read_text())
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer, limits=limits, entry=entry,
                launches=launches, readers=readers)
