"Small shared utilities: pattern strings and careful numerics."

from phlash_tpu_torch.utils.numerics import expm1inv, softplus, softplus_inv, texp_mean
from phlash_tpu_torch.utils.pattern import Pattern

__all__ = ["Pattern", "softplus", "softplus_inv", "expm1inv", "texp_mean"]
