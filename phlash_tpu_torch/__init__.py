"""phlash_tpu_torch: the PyTorch + CUDA port of phlash_tpu.

Bayesian PSMC by SVGD over a pair-coalescent HMM, for one NVIDIA H100: the
structured SMC' likelihood and its adjoint run as hand-written CUDA kernels
(phlash_tpu_torch/csrc, built with nvcc at first use), everything else is
plain PyTorch.  On the CPU the kernels' plain PyTorch versions stand in, for
testing.  A posterior is read with SizeHistory's evaluation methods,
confidence_band, save_posterior / load_posterior and repro.compare.  The
package imports torch, numpy and scipy, never JAX or phlash_tpu.
"""

from phlash_tpu_torch.cband import confidence_band
from phlash_tpu_torch.mcmc import fit
from phlash_tpu_torch.psmc import psmc
from phlash_tpu_torch.results import load_posterior, save_posterior
from phlash_tpu_torch.size_history import DemographicModel, SizeHistory

__all__ = ["fit", "psmc", "DemographicModel", "SizeHistory", "confidence_band",
           "save_posterior", "load_posterior"]
