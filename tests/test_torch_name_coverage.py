"""The port does all that phlash_tpu does: every public top-level name of
each phlash_tpu module (functions, classes, constants, `__all__`), and every
public method or property of its classes, exists in the port's counterpart
module, outside the not-to-port list below (ROADMAP.md, "Not to port").

phlash_tpu is read with `ast` and never imported; the port's modules are
imported, so names a class inherits count."""

import ast
import importlib
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent / "phlash_tpu"

# modules and names that are TPU or XLA concerns, or have no caller; the
# H100 path is tested without them (ROADMAP.md, "Not to port")
NOT_TO_PORT_MODULES = {
    "ops/autotune.py",  # kernel_seg_len="auto" is a no-op: tiles fixed in csrc/*_common.cuh
    "ops/check.py",  # oracle helpers of the sharded Pallas kernel
    "ops/pallas_smc.py", "ops/pallas_hmm.py", "ops/pallas_hmm_vjp.py",  # the Pallas kernels:
    # ported as csrc/*.cu behind ops/smc.py and ops/packed.py
    "utils/accurate.py",  # the f32-vs-f64 tests pass on native ops
    "utils/trees.py",  # the port keeps the cloud as batched tensors
}
NOT_TO_PORT_NAMES = {
    "ops/packing.py": {"block_diag_pack"},  # the TPU's MXU packing
    "utils/numerics.py": {"kahan_add", "invert_cpwli"},  # exported, called by nothing
    "utils/__init__.py": {"kahan_add", "invert_cpwli", "tree_stack", "tree_unstack"},
    "profiling.py": {"StepMeter"},  # folded into the fit's record, profiling.FitTrace
}
# the port's names for phlash_tpu's modules and classes
MODULE_RENAMES = {"ops/kernel_pallas.py": "ops/kernel_packed.py"}
CLASS_RENAMES = {"PureXLAKernel": "ScanKernel", "PallasKernel": "PackedKernel"}


def public_names(path: Path) -> dict:
    """{name: [public methods and properties]} of a module's source: its
    top-level functions, classes and assigned names (loggers aside) and the
    strings of its __all__."""
    names = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names[node.name] = [m.name for m in getattr(node, "body", ())
                                if isinstance(m, ast.FunctionDef)
                                and (not m.name.startswith("_") or m.name == "__call__")
                                ] if isinstance(node, ast.ClassDef) else []
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == "__all__":
                    names.update({n: [] for n in ast.literal_eval(node.value)})
                elif (isinstance(target, ast.Name) and not target.id.startswith("_")
                      and target.id != "logger"):
                    names[target.id] = []
    return names


MODULES = sorted(str(p.relative_to(ROOT)) for p in ROOT.rglob("*.py"))


def test_modules_listed():
    "The not-to-port and rename lists name modules phlash_tpu has."
    assert NOT_TO_PORT_MODULES | set(NOT_TO_PORT_NAMES) | set(MODULE_RENAMES) <= set(MODULES)


@pytest.mark.parametrize("rel", [m for m in MODULES if m not in NOT_TO_PORT_MODULES])
def test_port_has_every_public_name(rel):
    port_rel = MODULE_RENAMES.get(rel, rel)
    mod_name = "phlash_tpu_torch." + port_rel[:-3].replace("/", ".")
    mod = importlib.import_module(mod_name.removesuffix(".__init__"))
    skip = NOT_TO_PORT_NAMES.get(rel, set())
    missing = []
    for name, methods in public_names(ROOT / rel).items():
        if name in skip:
            continue
        obj = getattr(mod, CLASS_RENAMES.get(name, name), None)
        if obj is None:
            missing.append(name)
            continue
        missing += [f"{name}.{m}" for m in methods if not hasattr(obj, m)]
    assert not missing, f"{mod.__name__} lacks {missing}"
