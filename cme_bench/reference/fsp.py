"""Plain finite-state-projection reference for the benchmark's comparison.

Solves the Chemical Master Equation of a network given as data
(stoichiometry, a numpy propensity function, parameters) by
uniformization on a box of its own:

    p(t) = sum_k Poisson(k; lam * t) * P^k p(0),   P = I + A / lam,

with ``lam`` the largest exit rate in the box.  P is nonnegative and
column-stochastic, so every term is a sum of nonnegative numbers: the
result keeps its relative precision in every state, tiny ones included,
and the only error beside round-off is the mass that leaves the box.
Each reaction that would leave the box feeds an absorbing sink of the
species whose upper face it crosses; a species whose sink holds more than
its share of ``leak_tol`` gets its bound doubled, and the solve starts
again.

The state space is worked out here, from the network alone: every state
reachable from ``x0`` within the bounds.  Several parameter sets are
solved at once as the blocks of one block-diagonal matrix.

This module imports torch and numpy only: nothing of the program under
test and nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

#: the reference gives up after this many doublings of a bound
MAX_GROWTH = 4


@dataclasses.dataclass
class Network:
    """A reaction network as the reference sees it."""

    #: (R, d) integer state change of each reaction
    stoichiometry: np.ndarray
    #: (states (n, d) float64, params (P,) float64) -> (n, R) float64
    propensities: object


@dataclasses.dataclass
class Solution:
    """Distributions at t of one or more parameter sets on one state set."""

    states: np.ndarray  #: (n, d) int64, sorted by key
    keys: np.ndarray  #: (n,) int64 mixed-radix keys of ``states``
    bounds: np.ndarray  #: (d,) exclusive upper bound of each species
    p: np.ndarray  #: (K, n) float64 probabilities
    leak: np.ndarray  #: (K, d) mass that left through each upper face

    def lookup(self, states) -> np.ndarray:
        """Index of each row of ``states`` in ``self.states``; -1 where a
        state is outside the reference's space."""
        s = np.asarray(states, dtype=np.int64)
        inside = np.all((s >= 0) & (s < self.bounds), axis=1)
        k = _keys(np.where(inside[:, None], s, 0), self.bounds)
        pos = np.minimum(np.searchsorted(self.keys, k), self.keys.size - 1)
        found = inside & (self.keys[pos] == k)
        return np.where(found, pos, -1)


def _keys(states: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    radix = np.cumprod(np.concatenate([[1], bounds[:-1]])).astype(np.int64)
    return states @ radix


def reachable(stoich: np.ndarray, x0, bounds) -> np.ndarray:
    """Every state reachable from ``x0`` by the reactions' state changes
    while all counts stay in [0, bounds), sorted by key."""
    bounds = np.asarray(bounds, dtype=np.int64)
    start = np.asarray(x0, dtype=np.int64)[None, :]
    if np.any(start < 0) or np.any(start >= bounds):
        raise ValueError(f"x0 {x0} outside the bounds {bounds.tolist()}")
    seen = _keys(start, bounds)
    frontier = start
    while frontier.size:
        nxt = (frontier[:, None, :] + stoich[None, :, :]).reshape(
            -1, len(bounds))
        nxt = nxt[np.all((nxt >= 0) & (nxt < bounds), axis=1)]
        k = np.unique(_keys(nxt, bounds))
        k = k[~np.isin(k, seen, assume_unique=True)]
        seen = np.union1d(seen, k)
        frontier = _unkey(k, bounds)
    return _unkey(seen, bounds)


def _unkey(keys: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    out = np.empty((keys.size, len(bounds)), dtype=np.int64)
    rest = keys.copy()
    for s, b in enumerate(bounds):
        out[:, s] = rest % b
        rest //= b
    return out


def _blocks(net: Network, states, bounds, param_sets):
    """COO entries of the generators (without the diagonal), per block,
    and each block's exit rates: rows are targets, columns sources."""
    n, d = states.shape
    keys = _keys(states, bounds)
    rows, cols, vals, exits = [], [], [], []
    for k, params in enumerate(param_sets):
        a = np.asarray(net.propensities(states.astype(np.float64),
                                        np.asarray(params, np.float64)),
                       dtype=np.float64)
        if a.shape != (n, len(net.stoichiometry)):
            raise ValueError(f"propensities gave {a.shape}, want "
                             f"{(n, len(net.stoichiometry))}")
        if np.any(a < 0) or not np.all(np.isfinite(a)):
            raise ValueError("negative or non-finite propensity")
        off = k * (n + d)
        for r, nu in enumerate(net.stoichiometry):
            live = a[:, r] > 0
            src = np.nonzero(live)[0]
            tgt = states[src] + nu
            if np.any(tgt < 0):
                raise ValueError(f"reaction {r} fires into a negative count")
            over = tgt >= bounds
            out = np.any(over, axis=1)
            face = np.argmax(over, axis=1)
            inside = ~out
            j = np.searchsorted(keys, _keys(tgt[inside], bounds))
            rows += [off + j, off + n + face[out]]
            cols += [off + src[inside], off + src[out]]
            vals += [a[src[inside], r], a[src[out], r]]
        exits.append(a.sum(axis=1))
    return (np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
            np.stack(exits))


def poisson_weights(mean: float) -> tuple[int, np.ndarray]:
    """(first k, weights from it) of Poisson(mean), cut where a weight is
    below 1e-30 on the left and at mean + 10 sd + 20 on the right."""
    kmax = int(math.ceil(mean + 10.0 * math.sqrt(mean) + 20.0))
    k = np.arange(kmax + 1, dtype=np.float64)
    logw = -mean + k * (math.log(mean) if mean > 0 else 0.0) - np.array(
        [math.lgamma(x + 1.0) for x in k])
    w = np.exp(logw)
    lo = int(np.argmax(w >= 1e-30))
    return lo, w[lo:]


def _uniformized(net, states, bounds, x0, t, param_sets, device, dtype):
    n, d = states.shape
    K = len(param_sets)
    rows, cols, vals, exits = _blocks(net, states, bounds, param_sets)
    lam = float(exits.max())
    size = K * (n + d)
    diag = np.concatenate([
        np.concatenate([1.0 - e / lam, np.ones(d)]) for e in exits])
    idx = np.arange(size)
    coo = np.stack([np.concatenate([rows, idx]), np.concatenate([cols, idx])])
    with warnings.catch_warnings():  # torch's "sparse CSR is in beta"
        warnings.simplefilter("ignore", UserWarning)
        P = torch.sparse_coo_tensor(
            torch.from_numpy(coo).to(device),
            torch.from_numpy(np.concatenate([vals / lam, diag])).to(
                device, dtype),
            (size, size)).coalesce().to_sparse_csr()
    start = int(np.searchsorted(_keys(states, bounds),
                                _keys(np.asarray(x0)[None, :], bounds))[0])
    v = torch.zeros(size, dtype=dtype, device=device)
    v[torch.arange(K, device=device) * (n + d) + start] = 1.0
    lo, w = poisson_weights(lam * t)
    y = torch.zeros_like(v)
    for k in range(lo + w.size):
        if k >= lo:
            y.add_(v, alpha=float(w[k - lo]))
        if k + 1 < lo + w.size:
            v = torch.mv(P, v)
    out = y.double().cpu().numpy().reshape(K, n + d)
    return out[:, :n], out[:, n:]


def solve(net: Network, x0, t: float, param_sets, bounds, *,
          leak_tol: float = 1e-12, device="cpu",
          dtype=torch.float64) -> Solution:
    """The distributions at ``t`` from ``x0`` of every parameter set, on the
    reachable states within ``bounds`` (doubled per species until each
    parameter set leaks at most ``leak_tol`` in all)."""
    bounds = np.asarray(bounds, dtype=np.int64).copy()
    stoich = np.asarray(net.stoichiometry, dtype=np.int64)
    for _ in range(MAX_GROWTH + 1):
        states = reachable(stoich, x0, bounds)
        p, leak = _uniformized(net, states, bounds, np.asarray(x0),
                                      t, param_sets, device, dtype)
        if leak.sum(axis=1).max() <= leak_tol:
            return Solution(states, _keys(states, bounds), bounds, p, leak)
        grow = leak.max(axis=0) > leak_tol / len(bounds)
        grow[np.argmax(leak.max(axis=0))] = True
        bounds = np.where(grow, 2 * bounds, bounds)
    raise RuntimeError(f"the reference leaks {leak.sum(axis=1).max():.3e} "
                       f"> {leak_tol:g} at bounds {bounds.tolist()}")
