"""PSMC-style parameter-tying pattern strings.

A pattern like ``"14*1+1*2"`` describes how the M time-discretization
intervals of the coalescent HMM share free parameters: here 14 groups of
width 1 followed by 1 group of width 2, so M=16 intervals are controlled by
15 free parameters.  A copy of
phlash_tpu/utils/pattern.py: it is numpy-only, but importing it from
phlash_tpu would load JAX.  `expand` indexes the last axis, so it takes numpy
arrays and torch tensors with leading batch axes alike.
"""

from __future__ import annotations

import numpy as np


class Pattern:
    """Parse and apply a PSMC parameter-tying pattern string."""

    def __init__(self, pattern: str):
        widths: list[int] = []
        try:
            for term in pattern.split("+"):
                if "*" in term:
                    reps, w = term.split("*")
                    widths.extend([int(w)] * int(reps))
                else:
                    widths.append(int(term))
        except Exception as e:  # noqa: BLE001 - uniform error for any parse failure
            raise ValueError(f"could not parse pattern {pattern!r}") from e
        if not widths:
            raise ValueError("pattern must contain at least one epoch")
        if min(widths) <= 0:
            raise ValueError("epochs must be positive")
        self.pattern = pattern
        self._widths = widths
        # expand_index[i] = index of the free parameter controlling interval i
        self._expand_index = np.repeat(np.arange(len(widths)), widths)

    @property
    def M(self) -> int:
        "Total number of time intervals."
        return int(self._expand_index.shape[0])

    def __len__(self) -> int:
        "Number of free (tied) parameter groups."
        return len(self._widths)

    def expand(self, x):
        """Map a length-len(self) vector of group values to a length-M vector.

        Works on numpy arrays and torch tensors; leading axes are batch axes.
        """
        assert x.shape[-1] == len(self)
        return x[..., self._expand_index]

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"Pattern({self.pattern!r}, M={self.M}, groups={len(self)})"
