"""docs/torch_example.py, the port's walkthrough (BCF -> contig -> fit with
mesh, checkpoint, steps_per_call and held-out data -> plot -> confidence
band), against docs/example.py on the CPU: steps 1-3 (the BCF and its
index byte for byte, the loaded contigs' het matrices and AFS) and the fit
call's options; the walkthrough end to end at a small size in a process of
its own (its one-rank gloo world dies with it), and at its full size in the
heavy lane, as tests/test_example.py runs docs/example.py.  Also the
readings chip_smoke.py phase 14 takes of it: the kernel shapes from the
fit's chunking and the launches of calls of 5."""

import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import phlash_tpu  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "docs" / "torch_example.py"
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

L_SMALL = 20_000  # windows of steps 1-3 and of the small end-to-end run
SMALL = dict(L_windows=L_SMALL, chunk_size=1000, niter=10, num_particles=8)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ex = _load(SCRIPT, "torch_example")
jax_ex = _load(ROOT / "docs" / "example.py", "jax_example")


@pytest.mark.parametrize("seed", [1, 2])
def test_simulate_to_bcf_writes_docs_example_bytes(tmp_path, seed):
    "Steps 1-2: the same BCF and .csi as docs/example.py's, byte for byte, and the same span."
    ours, theirs = tmp_path / "ours.bcf", tmp_path / "theirs.bcf"
    _, span = ex.simulate_to_bcf(str(ours), L_SMALL, seed=seed)
    _, jspan = jax_ex.simulate_to_bcf(str(theirs), L_SMALL, seed=seed)
    assert span == jspan == L_SMALL * ex.WINDOW
    assert ours.read_bytes() == theirs.read_bytes()
    assert Path(f"{ours}.csi").read_bytes() == Path(f"{theirs}.csi").read_bytes()


@pytest.mark.parametrize("part", ["train", "held_out"])
def test_contigs_equal_docs_example(tmp_path, part):
    """Step 3: the training region (the first 4/5 of the span) and the
    held-out rest, loaded by phlash_tpu_torch.contig from the port's BCF,
    give phlash_tpu.contig's het matrix and AFS (docs/example.py:80-84's
    regions) from docs/example.py's BCF."""
    ours, theirs = str(tmp_path / "ours.bcf"), str(tmp_path / "theirs.bcf")
    _, span = ex.simulate_to_bcf(ours, L_SMALL)
    jax_ex.simulate_to_bcf(theirs, L_SMALL)
    got = dict(zip(("train", "held_out"), ex.load(ours, span)))[part]
    region = {"train": f"chr1:1-{span * 4 // 5}",
              "held_out": f"chr1:{span * 4 // 5 + 1}-{span}"}[part]
    want = phlash_tpu.contig(theirs, samples=["sample1"], region=region)
    g, w = got.get_data(ex.WINDOW), want.get_data(ex.WINDOW)
    assert g["het_matrix"].shape == (1, {"train": 4, "held_out": 1}[part] * L_SMALL // 5)
    assert (g["het_matrix"] == 1).sum() > 0
    np.testing.assert_array_equal(g["het_matrix"], w["het_matrix"])
    np.testing.assert_array_equal(g["afs"], w["afs"])


def _fit_keywords(main) -> list[str]:
    return [kw.arg for kw in chip_smoke.fit_call(main).keywords]


def test_fit_options_equal_docs_example():
    """Step 4: the port's fit call names docs/example.py's keywords plus
    device=, and its options (chip_smoke.fit_call_options: literals, and
    main's defaults for the sizes) are docs/example.py's; main's default
    windows are docs/example.py's."""
    assert _fit_keywords(ex.main) == ["test_data", "device", *_fit_keywords(jax_ex.main)[1:]]
    options = chip_smoke.fit_call_options(ex.main)
    assert options == chip_smoke.fit_call_options(jax_ex.main) == dict(
        steps_per_call=5, niter=40, num_particles=32, overlap=100, chunk_size=5000,
        num_workers=1, elpd_cutoff=30, progress=False)
    sim_default = inspect.signature(jax_ex.simulate_to_bcf).parameters["L_windows"].default
    assert inspect.signature(ex.main).parameters["L_windows"].default == sim_default


def test_chip_smoke_reads_the_walkthrough_shapes(tmp_path):
    """chip_smoke.example_shapes, phase 14's gate shapes, from the fit's own
    chunking of the full-size data: 24 training chunks of 5,000 + 100 over
    40 iterations give S = 1; 6 held-out chunks give the ELPD's S = 4; the
    cloud is 32 particles."""
    sh = chip_smoke.example_shapes(ex, str(tmp_path))
    assert (sh["chunks"], sh["held_out_chunks"], sh["S"], sh["S_elpd"]) == (24, 6, 1, 4)
    assert sh["gate"] == ((32, 1, 5000), (32, 1, 100), (32, 4, 5000), (32, 4, 100))


@pytest.mark.parametrize("niter", [10, 30, 300])
@pytest.mark.parametrize("elpd", [True, False])
def test_expected_counts_follow_the_fit_schedule(niter, elpd):
    """chip_smoke.expected_counts: in calls of 10 every call carries the
    ELPD, so one capture (its warm-up iteration and ELPD); in calls of 5 the
    ELPD rides every other call, so two captures of five iterations, one
    with the ELPD, and ceil(niter / 10) ELPDs by replay."""
    ten = chip_smoke.expected_counts("smc", niter, elpd)
    steps, elpds = niter + 1, (niter // 10 + 1 if elpd else 0)
    assert ten["smc"]["backward_cuda"] == 2 * steps
    assert ten["smc"]["forward_cuda"] == 2 * steps + 2 * elpds
    assert ten["assembly"]["forward_cuda"] == steps + elpds
    five = chip_smoke.expected_counts("smc", niter, elpd, spc=5)
    steps, elpds = niter + (2 if elpd else 1), (-(-niter // 10) + 1 if elpd else 0)
    assert five["smc"]["forward_cuda_residuals"] == five["smc"]["backward_cuda"] == 2 * steps
    assert five["smc"]["forward_cuda"] == 2 * steps + 2 * elpds
    assert five["assembly"] == dict(forward_cuda=steps + elpds, backward_cuda=steps,
                                    forward_plain=0, backward_plain=0)
    assert five["svgd"] == chip_smoke.svgd_counts(steps)
    assert set(five["packed"].values()) == {0}


def _check_run(out: Path, proc, niter: int, particles: int) -> None:
    """What a walkthrough run on the CPU leaves: exit 0 and DONE, the BCF, the
    checkpoint of `particles` after `niter` iterations, the figure (matplotlib
    is here), an ordered band, and exactly the plain launches of niter eager
    iterations (each the filter and the likelihood, each forward and adjoint;
    A1 + A2; the update's plain versions) and of the ELPD every 10 (two
    forwards and A1), nothing on CUDA and nothing packed."""
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == f"DONE: {out}"
    assert (out / "example.bcf").is_file() and (out / "example.bcf.csi").is_file()
    assert (out / "posterior.png").is_file()
    with np.load(out / "fit_ckpt.npz") as z:
        assert int(z["__meta"][0]) == niter and z["particles"].shape[0] == particles
    (card,) = [json.loads(x[len("card: "):]) for x in lines if x.startswith("card: ")]
    assert card["card"] == "cpu" and card["band_points"] == 32
    assert 0.0 <= card["band_min_gap"] < float("inf")
    elpds = -(-niter // 10)
    none = dict(forward_cuda=0, backward_cuda=0, forward_plain=0, backward_plain=0)
    assert card["launches"] == {
        "smc": dict(none, forward_cuda_residuals=0, forward_plain=2 * niter + 2 * elpds,
                    backward_plain=2 * niter),
        "packed": none,
        "assembly": dict(none, forward_plain=niter + elpds, backward_plain=niter),
        "svgd": dict(distances_cuda=0, bandwidth_cuda=0, update_cuda=0, bandwidth_plain=niter,
                     direction_plain=niter, amsgrad_plain=niter)}
    assert f"posterior: {particles} DemographicModel samples" in proc.stdout


def test_walkthrough_end_to_end_on_the_cpu(tmp_path):
    """main(device="cpu") at 20,000 windows, chunks of 1,000 + 100, 10
    iterations of 8 particles, with every option of the walkthrough (a
    one-rank gloo mesh, the checkpoint, calls of 5, held-out data), in a
    process of its own (~15 s on one core)."""
    out = tmp_path / "out"
    code = (f"import torch; torch.set_num_threads(1); import importlib.util as u; "
            f"s = u.spec_from_file_location('ex', {str(SCRIPT)!r}); m = u.module_from_spec(s); "
            f"s.loader.exec_module(m); m.main({str(out)!r}, device='cpu', **{SMALL!r})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)
    _check_run(out, proc, SMALL["niter"], SMALL["num_particles"])


def test_walkthrough_needs_a_card_by_default(tmp_path):
    """Without --device the script runs on the card: with none it raises
    before it writes anything, and never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py phase 14 runs the script there")
    out = tmp_path / "out"
    proc = subprocess.run([sys.executable, str(SCRIPT), str(out)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not out.exists()


def test_walkthrough_imports_neither_jax_nor_phlash_tpu(tmp_path):
    "Importing the script (and so the port's entry points it uses) loads no JAX and no phlash_tpu."
    code = (f"import sys, importlib.util as u; s = u.spec_from_file_location('ex', "
            f"{str(SCRIPT)!r}); m = u.module_from_spec(s); s.loader.exec_module(m); "
            f"print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'phlash_tpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


@pytest.mark.heavy  # the full-size fit on the CPU: ~2 min on one core
def test_walkthrough_full_size_on_the_cpu(tmp_path):
    "python docs/torch_example.py OUT --device cpu at its own size (150,000 windows, 40 x 32)."
    out = tmp_path / "out"
    proc = subprocess.run([sys.executable, str(SCRIPT), str(out), "--device", "cpu"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=1800)
    _check_run(out, proc, 40, 32)
