"""tools/torch_validate.py, the port's posterior recovery against the truth,
on the CPU at a small size: its datasets against phlash_tpu.sim's bit for
bit, its metrics against tools/validate.py's arithmetic through
phlash_tpu.size_history, its fit options against tools/validate.py's, and
main() end to end on each simulator."""

import ast
import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from phlash_tpu import sim as jsim  # noqa: E402
from phlash_tpu.size_history import DemographicModel as JaxDM  # noqa: E402
from phlash_tpu.size_history import SizeHistory as JaxSH  # noqa: E402
from phlash_tpu_torch import convert  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load("torch_validate")
NAMES = ("constant", "bottleneck", "zigzag")


@pytest.mark.parametrize("n_samples", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_datasets_equal_phlash_tpu_sim(name, n_samples):
    """The tool's training and held-out contigs (L = 5,000) equal
    phlash_tpu.sim.simulate_smc_continuous's at seeds 0, 1, 2 and 99 bit for
    bit when both are given the port's model (phlash_tpu's zigzag rates go
    through XLA's sin)."""
    truth = tool.truths()[name]
    train, test = tool.datasets(truth, 5000, "continuous", n_samples)
    for got, seed in zip([*train, test], (0, 1, 2, 99)):
        want = jsim.simulate_smc_continuous(truth, L=5000, seed=seed, n_samples=n_samples)
        assert got.het_matrix.shape == (n_samples, 5000)
        np.testing.assert_array_equal(got.het_matrix, want.het_matrix)
        if n_samples == 1:
            np.testing.assert_array_equal(got.afs, want.afs)
        else:
            assert got.afs is None and want.afs is None


def _posterior(seed: int, n: int = 16, M: int = 16):
    """n random models as float32 values: phlash_tpu's (float64 of those
    values) and the port's (float32, carried across with convert)."""
    rng = np.random.default_rng(seed)
    jax_models = []
    for _ in range(n):
        t = np.concatenate([[0.0], np.sort(np.exp(rng.uniform(np.log(1e-3), np.log(15.0),
                                                               M - 1)))])
        c = np.exp(rng.normal(0.0, 0.7, M))
        t, c = (x.astype(np.float32).astype(np.float64) for x in (t, c))
        jax_models.append(JaxDM(eta=JaxSH(t=jnp.asarray(t), c=jnp.asarray(c)), theta=1e-2,
                                rho=jnp.asarray(1e-2)))
    ours = [convert.from_reference_dm(m, dtype=torch.float32) for m in jax_models]
    return jax_models, ours


@pytest.mark.parametrize("name", NAMES)
def test_metrics_match_the_jax_tool(name):
    """The tool's metrics of a 16-model posterior equal tools/validate.py:78-88
    computed through phlash_tpu.size_history.SizeHistory on the same values
    (the port's models in float32, evaluated on the host in float64): the
    grid, the band, the true Ne, the coverage and the tv, rtol 1e-10."""
    jax_post, post = _posterior(seed=NAMES.index(name) + 11)
    truth = getattr(jsim, f"{name}_demography")(theta=1e-2)
    # tools/validate.py:78-88
    grid = np.geomspace(truth.eta.quantile(0.05), truth.eta.quantile(0.95), 64)
    Ne = np.stack([np.asarray(dm.eta(grid, Ne=True)) for dm in jax_post])
    lo, med, hi = np.quantile(Ne, [0.025, 0.5, 0.975], axis=0)
    true_ne = np.asarray(truth.eta(grid, Ne=True))
    coverage = float(((true_ne >= lo) & (true_ne <= hi)).mean())
    med_eta = JaxSH(t=grid, c=1.0 / (2.0 * med))
    tv = float(truth.eta.tv(med_eta))

    m = tool.metrics(post, tool.truths()[name])
    for key, want in (("grid", grid), ("lo", lo), ("med", med), ("hi", hi),
                      ("true_ne", true_ne)):
        np.testing.assert_allclose(m[key], want, rtol=1e-10, err_msg=key)
    assert m["coverage"] == coverage
    np.testing.assert_allclose(m["tv"], tv, rtol=1e-10)
    assert 0.0 < tv < 1.0 and np.isfinite(m["tv_first_rate_back"])


def test_fit_options_are_the_jax_tools():
    """FIT_OPTIONS are the constant keywords of tools/validate.py's
    phlash_tpu.fit call (read with ast), and the seeds its PRNGKey and
    contig seeds."""
    tree = ast.parse((ROOT / "tools" / "validate.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute) and n.func.attr == "fit")
    consts = {k.arg: k.value.value for k in call.keywords if isinstance(k.value, ast.Constant)}
    assert {k: consts[k] for k in tool.FIT_OPTIONS} == tool.FIT_OPTIONS
    assert consts["num_workers"] == 1 and consts["progress"] is False
    key = next(k.value for k in call.keywords if k.arg == "key")
    assert key.args[0].value == tool.FIT_SEED
    seeds = {k.value.value for n in ast.walk(tree) if isinstance(n, ast.Call)
             for k in n.keywords if k.arg in ("seed", "key") and isinstance(k.value, ast.Constant)}
    assert seeds == {tool.TEST_SEED} and tool.TRAIN_SEEDS == (0, 1, 2)
    args = tool.parse_args([])
    quick = tool.parse_args(["--quick"])
    assert (args.L, args.niter, args.particles) == (500_000, 300, 500)
    assert (quick.L, quick.niter) == (100_000, 100)


@pytest.mark.parametrize("simulator", ["continuous", "hmm"])
def test_main_end_to_end_on_the_cpu(simulator, tmp_path, capsys):
    """main() at 8 particles, 3 iterations and 3,000 windows on the CPU:
    three demography lines with the iterations run and the device, the
    JSON line, the SUMMARY line last, the exit code by the 0.25 rule, the
    plain versions' launches only (one iteration a call on the CPU, one
    ELPD), and a plot a demography."""
    rc = tool.main(["--device", "cpu", "--simulator", simulator, "--L", "3000", "--niter", "3",
                    "--particles", "8", "--plot-dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("SUMMARY worst tv=")
    out = json.loads(lines[-2])
    for name in NAMES:
        line = next(x for x in lines if x.startswith(f"{name}: tv(median, truth) = "))
        assert "3 iterations run (of 3)" in line and line.endswith("; cpu")
    assert [r["name"] for r in out["demographies"]] == list(NAMES)
    assert rc == (0 if out["worst_tv"] < tool.TV_GATE else 1)
    assert out["worst_tv"] == max(r["tv"] for r in out["demographies"])
    assert lines[-1] == f"SUMMARY worst tv={out['worst_tv']:.3f}"
    for r in out["demographies"]:
        assert r["finite"] and r["samples"] == 8 and r["iterations"] == 3
        assert np.isfinite(r["tv"]) and 0.0 <= r["coverage"] <= 1.0
        assert set(r["tv_other_truths"]) == set(NAMES) - {r["name"]}
        n = r["launches"]
        assert (n["smc"]["forward_plain"], n["smc"]["backward_plain"]) == (2 * 3 + 2, 2 * 3)
        assert (n["assembly"]["forward_plain"], n["assembly"]["backward_plain"]) == (3 + 1, 3)
        assert all(v == 0 for mod, c in n.items() for k, v in c.items()
                   if "cuda" in k or mod == "packed")
        assert (tmp_path / f"validation_{r['name']}.png").stat().st_size > 0


# the held-out ELPD's subset: one a fit in the port, a fresh one an evaluation
# in phlash_tpu (ROADMAP.md §C).  n_samples=2 and 3,000 windows: the held-out
# contig gives 2 rows x 3 chunks of 600 + 500 windows, more than S = 5.
ELPD_FIT = dict(niter=21, num_particles=8, num_workers=1, progress=False, learning_rate=0.0,
                elpd_cutoff=50, theta=1e-4, t1=1e-3, tM=15.0, alpha=1.0, minibatch_size=5)


def _elpd_data():
    truth = tool.truths()["bottleneck"]
    return tool.datasets(truth, 3000, "continuous", 2)


def test_fit_evaluates_one_held_out_subset(monkeypatch):
    """With more held-out chunks than an evaluation visits and particles
    that do not move (learning_rate 0), every ELPD evaluation of a fit
    visits the same chunks and reads the same value: the ELPD follows the
    particles, not the draws."""
    from phlash_tpu_torch import mcmc, training

    seen = []

    class Recording(training.Caller):
        def __call__(self, state, inds, elpd_inds=None):
            state, e = super().__call__(state, inds, elpd_inds)
            if elpd_inds is not None:
                seen.append((elpd_inds.tolist(), float(e)))
            return state, e

    monkeypatch.setattr(mcmc, "Caller", Recording)
    contigs, test = _elpd_data()
    mcmc.fit(contigs, test_data=test, device="cpu", seed=7, **ELPD_FIT)
    assert len(seen) == 3 and len(seen[0][0]) == 5
    assert all(s == seen[0] for s in seen), seen


def test_phlash_tpu_draws_a_fresh_subset_each_evaluation(monkeypatch):
    """phlash_tpu.fit on the same data and options visits another subset of
    the held-out chunks at each evaluation, so its ELPD moves with the draws
    while the particles stand still: the fault the port no longer has
    (phlash_tpu stays as it is)."""
    import jax

    import phlash_tpu
    import phlash_tpu.mcmc as jmcmc

    seen, orig = [], jmcmc.log_density_batched

    def recording(particles, **kw):
        jax.debug.callback(lambda i: seen.append(np.asarray(i).tolist()), kw["inds"])
        return orig(particles, **kw)

    monkeypatch.setattr(jmcmc, "log_density_batched", recording)
    contigs, test = _elpd_data()
    phlash_tpu.fit(contigs, test_data=test, key=jax.random.PRNGKey(7), **ELPD_FIT)
    assert len(seen) >= 2 and all(len(s) == 5 for s in seen)
    assert any(s != seen[0] for s in seen), seen
