"""Every tool and walkthrough of the repo has a counterpart in the port, or a
stated reason why not: each tools/*.py that is not a torch_* tool has
tools/torch_<name>.py (or a named rename), or stands in NOT_TO_PORT_TOOLS
with a one-line reason that ROADMAP.md's "Not to port" repeats on the
tool's row; each docs/*.py that is not a torch_* script likewise has
docs/torch_<name>.py or a reason in NOT_TO_PORT_DOCS, and a row in the same
table."""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"
DOCS = ROOT / "docs"

# the port's names for tools whose counterpart is not tools/torch_<name>.py
TOOL_RENAMES = {"vpu_peak": "torch_sm_peak", "genome_scale_demo": "torch_genome_scale_demo"}
TPU_ONLY = ("TPU/XLA-only: it times or probes phlash_tpu's Pallas kernels, their layouts, "
            "the TPU's arithmetic or XLA's compile of the step")
F32_XLA = ("phlash_tpu's float32 assembly graph on XLA: the port's A2 is held to its plain "
           "version by chip_smoke.py phase 3c, its recovery by tools/torch_validate.py")
REFERENCE = ("needs the upstream phlash sources checked out beside the repo (the reference "
             "that tools/ref_parity.py imports), which the repo does not carry")
NOT_TO_PORT_TOOLS = {
    "decode_ab": TPU_ONLY,
    "layout_ab": TPU_ONLY,
    "step_compile": TPU_ONLY,
    "sharded_adjoint_probe": TPU_ONLY,
    "f32_xplat": TPU_ONLY,
    "f32_bisect": F32_XLA,
    "f32_combo": F32_XLA,
    "f32_stage": F32_XLA,
    "f32_traj": F32_XLA,
    "f32_dynamics": F32_XLA,
    "ref_parity": REFERENCE,
    "posterior_repro": REFERENCE,
    "tpu_check": "covered by the port's own check: chip_smoke.py holds every hand kernel to "
                 "its plain version on the card",
    "kernel_bench": "covered by the port's own check: chip_smoke.py phases 5 and 9 (the "
                    "kernel times and the port's bench)",
    "vendored_svgd": "the oracle of phlash_tpu.svgd: the port's svgd is held to phlash_tpu.svgd "
                     "(tests/test_torch_model.py)",
    "pod_dryrun": "the 8-device virtual mesh of XLA; tests/test_torch_parallel.py holds the "
                  "port's mesh on gloo worlds of 2 and 4 (sharded step equal to the unsharded "
                  "one, collectives far below the chunk tensor, slices outermost), not the "
                  "per-device bytes of 10^5 chunks on 8 devices",
}

# docs/*.py scripts of the JAX side that have no docs/torch_<name>.py, with the reason
NOT_TO_PORT_DOCS = {}

JAX_TOOLS = sorted(p.stem for p in TOOLS.glob("*.py") if not p.stem.startswith("torch_"))
JAX_DOCS = sorted(p.stem for p in DOCS.glob("*.py") if not p.stem.startswith("torch_"))


def roadmap_row(name: str, folder: str = "tools") -> str:
    "ROADMAP.md's line that names <folder>/<name>.py in its tool table ('' if none)."
    for line in (ROOT / "ROADMAP.md").read_text().splitlines():
        if line.startswith("|") and f"`{folder}/{name}.py`" in line:
            return line
    return ""


def test_lists_name_tools_the_repo_has():
    "The not-to-port and rename lists name tools that exist, and no tool is in both."
    assert set(NOT_TO_PORT_TOOLS) | set(TOOL_RENAMES) <= set(JAX_TOOLS)
    assert not set(NOT_TO_PORT_TOOLS) & set(TOOL_RENAMES)
    for port in TOOL_RENAMES.values():
        assert (TOOLS / f"{port}.py").is_file(), port


@pytest.mark.parametrize("name", JAX_TOOLS)
def test_tool_has_a_counterpart_or_a_reason(name):
    """tools/<name>.py has tools/torch_<name>.py (or its rename), or a reason
    in NOT_TO_PORT_TOOLS that ROADMAP.md's row for the tool repeats; a tool
    with a counterpart has a row that names it."""
    port = TOOL_RENAMES.get(name, f"torch_{name}")
    row = roadmap_row(name)
    assert row, f"ROADMAP.md has no tool-table row for tools/{name}.py"
    if (TOOLS / f"{port}.py").is_file():
        assert name not in NOT_TO_PORT_TOOLS, f"{name} is ported and listed as not to port"
        assert f"`tools/{port}.py`" in row, row
    else:
        assert name in NOT_TO_PORT_TOOLS, f"tools/{name}.py has no counterpart and no reason"
        assert NOT_TO_PORT_TOOLS[name] in row, f"ROADMAP.md's row does not repeat the reason: {row}"


def test_docs_lists_name_scripts_the_repo_has():
    "NOT_TO_PORT_DOCS names docs/*.py scripts that exist; docs/example.py is among the scripts."
    assert set(NOT_TO_PORT_DOCS) <= set(JAX_DOCS)
    assert "example" in JAX_DOCS


@pytest.mark.parametrize("name", JAX_DOCS)
def test_doc_script_has_a_counterpart_or_a_reason(name):
    """docs/<name>.py has docs/torch_<name>.py, or a reason in NOT_TO_PORT_DOCS
    that ROADMAP.md's row for it repeats; a script with a counterpart has a
    row that names it."""
    row = roadmap_row(name, "docs")
    assert row, f"ROADMAP.md has no tool-table row for docs/{name}.py"
    if (DOCS / f"torch_{name}.py").is_file():
        assert name not in NOT_TO_PORT_DOCS, f"{name} is ported and listed as not to port"
        assert f"`docs/torch_{name}.py`" in row, row
    else:
        assert name in NOT_TO_PORT_DOCS, f"docs/{name}.py has no counterpart and no reason"
        assert NOT_TO_PORT_DOCS[name] in row, f"ROADMAP.md's row does not repeat the reason: {row}"
