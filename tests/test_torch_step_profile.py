"""tools/torch_step_profile.py, the port's ablation profile of the SVGD
step, on the CPU at a tiny size: its last line's keys are
tools/step_profile.py's row names (read with ast), every value finite and
positive, and each row launched what its variant runs (the plain versions,
on the CPU) and nothing else."""

import ast
import importlib.util
import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_rows() -> list[str]:
    "The row names of tools/step_profile.py: the first argument of each record(...) call."
    tree = ast.parse((ROOT / "tools" / "step_profile.py").read_text())
    return [n.args[0].value for n in ast.walk(tree) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name) and n.func.id == "record"
            and isinstance(n.args[0], ast.Constant)]


# per iteration of each row, on the plain versions: (B2 + B3 pairs, A1 + A2 pairs)
PER_ITERATION = {"full": (2, 1), "-afs": (2, 1), "-warmup": (1, 1),
                 "-sites (64-site chunks)": (2, 1), "svgd-only (stub grad)": (0, 0),
                 "kernel fwd+grad only": (1, 0), "assembly fwd+grad only": (0, 1)}


@pytest.fixture(scope="module")
def profile():
    "The tool on the CPU: 4 particles, chunks of 8 + 64 windows, 10 chunks; (stdout lines, result)."
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = _load("torch_step_profile").main(
            ["--device", "cpu", "--particles", "4", "--chunk", "64", "--overlap", "8",
             "--nchunks", "10"])
    return buf.getvalue().strip().splitlines(), out


def test_last_line_has_the_jax_rows(profile):
    "The last line's keys are tools/step_profile.py's row names, in order; values finite > 0."
    lines, out = profile
    rows = json.loads(lines[-1])
    assert list(rows) == jax_rows() == list(PER_ITERATION)
    assert all(math.isfinite(v) and v > 0 for v in rows.values()), rows
    assert rows == out["rows"]


@pytest.mark.parametrize("row", list(PER_ITERATION))
def test_row_launches_its_variant(profile, row):
    """A row's JSON line: graphed and eager ms finite and positive, and
    exactly its variant's plain launches for the iterations it ran (no CUDA
    launch, nothing packed)."""
    lines, _ = profile
    d = next(json.loads(x) for x in lines if x.startswith('{"row": ' + json.dumps(row)))
    assert all(math.isfinite(d[k]) and d[k] > 0 for k in ("graphed_ms", "eager_ms"))
    n = d["iterations"]
    hmm, asm = PER_ITERATION[row]
    c = d["launches"]
    assert (c["smc"]["forward_plain"], c["smc"]["backward_plain"]) == (hmm * n, hmm * n)
    assert (c["assembly"]["forward_plain"], c["assembly"]["backward_plain"]) == (asm * n, asm * n)
    assert all(v == 0 for mod, m in c.items() for k, v in m.items()
               if "cuda" in k or mod == "packed")
