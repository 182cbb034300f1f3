"""Solution-query helpers shared by both solver front-ends.

The reference exposes only a point lookup (``POINTWISE_FSP``,
reference/src/state_space/StateSpace.f90:96-114) and leaves any
post-processing of (states, vector) to the caller.  These helpers cover the
standard CME post-processing — per-species marginal distributions and
moments — as plain NumPy reductions over the final (n, d) state array and
(n,) probability vector.
"""

from __future__ import annotations

import numpy as np


def marginal(states: np.ndarray, probs: np.ndarray, species: int) -> np.ndarray:
    """Marginal distribution of one species: out[c] = P[x_species = c].

    Length is max observed count + 1; entries sum to the captured mass
    (wsum <= 1 under FSP truncation).
    """
    counts = np.asarray(states)[:, species].astype(np.int64)
    return np.bincount(counts, weights=np.asarray(probs))


def mean(states: np.ndarray, probs: np.ndarray) -> np.ndarray:
    """Per-species mean molecule counts E[x_s] (normalized by wsum)."""
    p = np.asarray(probs, dtype=np.float64)
    w = p.sum()
    return (np.asarray(states, dtype=np.float64).T @ p) / w


def variance(states: np.ndarray, probs: np.ndarray) -> np.ndarray:
    """Per-species variance Var[x_s] (normalized by wsum)."""
    s = np.asarray(states, dtype=np.float64)
    p = np.asarray(probs, dtype=np.float64)
    w = p.sum()
    mu = (s.T @ p) / w
    return (np.square(s).T @ p) / w - np.square(mu)
