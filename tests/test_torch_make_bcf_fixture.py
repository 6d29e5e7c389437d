"""tools/torch_make_bcf_fixture.py writes, through the port's
io.bcf.write_bcf, the JAX package's tests/fixtures/sample.bcf and its .csi
byte for byte."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "sample.bcf"


def test_writes_the_fixture_byte_for_byte(tmp_path):
    out = tmp_path / "sub" / "sample.bcf"
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_make_bcf_fixture.py"),
                           str(out)], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert out.read_bytes() == FIXTURE.read_bytes()
    assert Path(f"{out}.csi").read_bytes() == Path(f"{FIXTURE}.csi").read_bytes()


def test_the_output_path_must_be_given(tmp_path):
    "Without a path the tool writes nothing and exits non-zero (argparse)."
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_make_bcf_fixture.py")],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and not list(tmp_path.iterdir())
