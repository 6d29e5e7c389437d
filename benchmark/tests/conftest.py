"""Shared by the harness's tests: the checkout's root on sys.path, and cells cut to a CPU's size."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_cell(name: str, particles: int = 16):
    """The cell `name` at a size a CPU test holds: the genome at 0.2% of its
    length, `particles` particles, overlaps of 20 (or 10) windows, and a
    short chunk size where the mix sets one."""
    from benchmark import cells

    cell = cells.load(name, ROOT)
    cell.config["data"]["scale"] = 0.002
    cell.config["fit"].update(num_particles=particles, num_workers=2)
    fit = cell.traffic["fit"]
    fit["overlap"] = 20 if fit["overlap"] >= 500 else 10
    if fit.get("chunk_size"):
        fit["chunk_size"] = 50
    cell.traffic.update(trace_skip_calls=1, trace_seconds=0.5)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
