"""Nothing the benchmark runs imports JAX or phlash_tpu; the reference, nothing of the program.

Top-level module names are compared whole: phlash_tpu_torch begins with
phlash_tpu and is not it."""

import subprocess
import sys
import types

from conftest import ROOT

HARNESS = """
import sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.cells, benchmark.inputs, benchmark.window, benchmark.tracing
import benchmark.inputs.vcf, benchmark.inputs.matrix
import benchmark.check, benchmark.shapes, benchmark.counts, benchmark.readings
import benchmark.frozen.roofline, benchmark.frozen.genome
from benchmark import cells
for w in ("diploid.genome", "cohort.genome", "diploid.short_chunks"):
    cells.load(w)
import phlash_tpu_torch, phlash_tpu_torch.mcmc, phlash_tpu_torch.data
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.fit, benchmark.reference.model, benchmark.reference.hmm
import benchmark.reference.svgd
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], capture_output=True,
                         text=True, timeout=240, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_readers_and_port_leave_jax_out():
    names = top_level(HARNESS)
    assert "phlash_tpu_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "phlash_tpu"}


def test_reference_imports_nothing_of_the_program():
    names = top_level(REFERENCE)
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "phlash_tpu", "phlash_tpu_torch"}


def test_the_runs_own_check_compares_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "phlash_tpu_torch.something", types.ModuleType("x"))
    loaded = {m.split(".")[0] for m in sys.modules}
    assert ("phlash_tpu" in run.forbidden_modules()) == ("phlash_tpu" in loaded)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("jaxlib.xla_client"))
    assert "jaxlib" in run.forbidden_modules()
