"""Where the held-out ELPD's early stop comes from, on the CPU: phlash_tpu.fit
and the port's fit with phlash_tpu's subset policy (a fresh subset of the
held-out chunks at each evaluation) on tools/validate.py's two-sample
bottleneck data and its --quick options, at 5,000 windows and 8 particles.
Both return the cloud of their first evaluation and stop early, so the
fault belongs to the policy both share and not to the port; the port's
fit, which draws one subset a fit, runs on (ROADMAP.md §C)."""

import importlib.util
import logging
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("torch_validate",
                                               ROOT / "tools" / "torch_validate.py")
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

L, NITER = 5000, 100  # the --quick niter, and its cutoff max(50, niter // 4)
OPTIONS = dict(niter=NITER, num_particles=8, num_workers=1, progress=False,
               elpd_cutoff=max(50, NITER // 4), **tool.FIT_OPTIONS)
BEST = r"best-ELPD state from iteration (\d+)"  # both packages' log record


def _data():
    return tool.datasets(tool.truths()["bottleneck"], L, "continuous", 2)


def _stop(caplog, logger: str) -> tuple[int, bool]:
    "(the iteration whose cloud the fit returned, whether it stopped early) from its log."
    msgs = [r.getMessage() for r in caplog.records if r.name == logger]
    best = next(int(b) for m in msgs for b in re.findall(BEST, m))
    return best, any("stopping early" in m for m in msgs)


def test_phlash_tpu_stops_at_its_first_evaluation(caplog):
    """phlash_tpu.fit, a fresh subset each evaluation: the moving average
    never passes the first evaluation's, and the fit stops after
    elpd_cutoff iterations with the first evaluation's cloud."""
    import jax

    import phlash_tpu

    contigs, test = _data()
    with caplog.at_level(logging.INFO, logger="phlash_tpu.mcmc"):
        phlash_tpu.fit(contigs, test_data=test, key=jax.random.PRNGKey(tool.FIT_SEED), **OPTIONS)
    assert _stop(caplog, "phlash_tpu.mcmc") == (0, True)


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh-subsets", "one-subset"])
def test_port_stops_at_its_first_evaluation_only_with_fresh_subsets(fresh, caplog, monkeypatch):
    """The port's fit on the same data and options: with a fresh subset at
    each evaluation (its draws before one subset a fit, from the same
    generator) it stops where phlash_tpu stops, with the first evaluation's
    cloud; with one subset the moving average follows the particles, and
    the fit runs all its iterations and returns a later cloud."""
    from phlash_tpu_torch import mcmc, training

    draws = mcmc.generators(tool.FIT_SEED, torch.device("cpu"))[1]

    class FreshSubsets(training.Caller):
        def __call__(self, state, inds, elpd_inds=None):
            if elpd_inds is not None:
                elpd_inds = self.elpd.draw(draws)
            return super().__call__(state, inds, elpd_inds)

    if fresh:
        monkeypatch.setattr(mcmc, "Caller", FreshSubsets)
    contigs, test = _data()
    with caplog.at_level(logging.INFO, logger="phlash_tpu_torch.mcmc"):
        mcmc.fit(contigs, test_data=test, device="cpu", seed=tool.FIT_SEED, **OPTIONS)
    best, stopped = _stop(caplog, "phlash_tpu_torch.mcmc")
    if fresh:
        assert (best, stopped) == (0, True)
    else:
        assert best > 0 and not stopped
