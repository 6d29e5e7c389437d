"""Linear transforms of the allele-frequency spectrum.

The AFS composite-likelihood term compares the observed spectrum to the
expected spectrum under the size history; these transforms (folding,
hypergeometric down-projection, Bhaskar–Wang–Song tail binning) act like
stochastic matrices applied to both.  Host-side numpy — computed once before
training.  A numpy copy of phlash_tpu/afs.py (importing it would load JAX).
"""

from __future__ import annotations

import numpy as np


def fold_transform(n: int) -> np.ndarray:
    """Fold an unpolarized spectrum: entry k merges with entry n-k.

    Returns a (ceil((n-1)/2), n-1) matrix; if n is even the middle class maps
    to itself with weight 1 (columns normalized so mass is counted once).
    """
    rows = (n - 1) // 2 + (n - 1) % 2
    T = np.eye(N=rows, M=n - 1)
    T += T[:, ::-1]
    T /= T.sum(0)
    return T


def project_transform(n: int, m: int) -> np.ndarray:
    """Hypergeometric projection of an n-sample AFS down to m samples."""
    from scipy.stats import hypergeom

    assert n >= m
    i, j = np.ogrid[1:m, 1:n]
    return hypergeom.pmf(M=n, N=m, n=j, k=i)


def bws_transform(afs, alpha: float = 0.1) -> np.ndarray:
    """Bhaskar–Wang–Song binning: keep entries covering the first (1-alpha)
    of cumulative mass individually; lump the rare tail into one bin."""
    afs = np.asarray(afs)
    n = len(afs) + 1
    cum = np.cumsum(afs) / afs.sum()
    k = np.searchsorted(cum, 1.0 - alpha, side="right") + 1
    T = np.eye(N=k, M=n - 1)
    if k < n - 1:
        cols = np.arange(n - 1)[None]
        T = np.concatenate([T, (cols >= k).astype(float)])
    return T


def default_afs_transform(afs) -> np.ndarray:
    "Default pipeline: fold, then BWS-bin the folded spectrum."
    T1 = fold_transform(len(afs) + 1)
    T2 = bws_transform(T1 @ np.asarray(afs))
    return T2 @ T1
