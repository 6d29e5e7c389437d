"""phlash_tpu_torch: the PyTorch + CUDA port of phlash_tpu.

Bayesian PSMC by SVGD over a pair-coalescent HMM, for one NVIDIA H100: the
structured SMC' likelihood and its adjoint run as hand-written CUDA kernels
(phlash_tpu_torch/csrc, built with nvcc at first use), everything else is
plain PyTorch.  On the CPU the kernels' plain PyTorch versions stand in, for
testing.  Genome files come in through `contig` (VCF, BCF, tree sequences)
or `psmc` (.psmcfa); a posterior is read with SizeHistory's evaluation
methods, confidence_band, plot_posterior, save_posterior / load_posterior
and repro.compare.  `python -m phlash_tpu_torch fit ...` is the command
line.  The package imports torch, numpy and scipy, never JAX or phlash_tpu.

The names below are imported when first used, so that a process that needs
only the host-side modules (the ingestion workers of data.init_mcmc_data)
does not import torch.
"""

import importlib
import sys
import types

_EXPORTS = {
    "fit": "mcmc",
    "contig": "data",
    "psmc": "psmc",
    "DemographicModel": "size_history",
    "SizeHistory": "size_history",
    "confidence_band": "cband",
    "plot_posterior": "plot",
    "save_posterior": "results",
    "load_posterior": "results",
}

__all__ = list(_EXPORTS)
__version__ = "0.1.0"  # pyproject.toml's, as phlash_tpu.__version__


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value


class _Package(types.ModuleType):
    """Keeps `psmc` the function when the import system binds the submodule
    of that name on the package, as an eager `from .psmc import psmc` would."""

    def __setattr__(self, name, value):
        if isinstance(value, types.ModuleType) and _EXPORTS.get(name) == name:
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
