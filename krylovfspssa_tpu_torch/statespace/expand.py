"""FSP state-space expansion of the table backend: 1-step reachability and
batched SSA walks (PyTorch port of ``krylovfspssa_tpu/statespace/expand.py``).

Reference: ``ONESTEP_EXTENDER`` (``reference/src/state_space/
StateSpace.f90:347-396``) adds, for every state, every legal reaction
successor not yet in the table; ``SSA_EXTENDER`` (StateSpace.f90:550-630)
runs one Gillespie walk from every state for a local time budget, adding
every visited state.

* 1-step: one batched key computation over all (state, reaction) pairs on
  the host, then a dedup-merge: the JAX package's states in its order.
* SSA: walks from all origins advance in lockstep on the device, in chunks
  of 2^16 origins, one Python iteration per jump (the JAX package runs
  ``vmap`` + ``lax.scan`` on chunks padded to powers of two).  Each jump
  evaluates the propensities at the walkers' states (``Model.propensities``)
  and draws from an explicit ``torch.Generator``; whether any walk is
  still alive is read every ``_ALIVE_EVERY`` jumps, not every jump.  The
  visited keys are made unique on the device before one copy to the
  host.  As in the JAX package, walks don't stop on re-entering swept
  territory (the reference's J >= J0 guard, StateSpace.f90:626) and take
  at most ``config.ssa_max_steps`` jumps.  The random stream is the
  port's own, so the states an expansion finds differ from the JAX
  package's; the FSP criterion guards the solution's accuracy either way.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.trace import spanned
from .table import StateTable

#: jumps between two reads of "is any walk still alive"
_ALIVE_EVERY = 8

#: the smallest uniform variate a waiting time uses: -log(r1) needs
#: r1 > 0, and torch.rand (like jax.random.uniform) may return 0
_R1_MIN = float(np.finfo(np.float64).tiny)


def onestep_candidates(table: StateTable, stoichiometry: np.ndarray):
    """Keys + states of all legal 1-step successors of active rows (host
    numpy; ``merge_keys`` filters the ones already present)."""
    stoich = np.asarray(stoichiometry, dtype=np.int32)
    enc = table.encoder
    n, d = table.n, enc.n_species
    R = stoich.shape[0]
    succ = table.states[:n, None, :] + stoich[None, :, :]  # (n, R, d)
    succ = succ.reshape(n * R, d)
    keys = enc.encode_np(succ)  # illegal successors -> INVALID_KEY
    return keys, succ


@spanned("onestep")
def onestep_extend(
    table: StateTable, stoichiometry: np.ndarray, max_capacity: int | None
) -> tuple[StateTable, int]:
    """One round of 1-step reachability expansion."""
    keys, succ = onestep_candidates(table, stoichiometry)
    return table.merge_keys(keys, succ, max_capacity)


# ---------------------------------------------------------------- SSA ----


def _ssa_walk(states, t_budget, generator, props_fn, stoich, encoder,
              max_steps):
    """Gillespie walks from each origin on the device.

    Args:
      states: (chunk, d) int32 walk origins.
      t_budget: the walks' time budget (host float).
      generator: the ``torch.Generator`` of the states' device.
      props_fn: (m, d) integer states -> (m, R) float64 propensities.
      stoich: (R, d) int32 tensor on the device.

    Returns the visited states' keys: (steps, chunk) int64 for one-word
    keys, -1 where nothing was visited; for several words, (steps, chunk,
    d) int32 states, -1 rows where nothing was visited.  ``steps`` is the
    number of jumps run (at most ``max_steps``; the loop stops early once
    every walk has ended).
    """
    chunk = states.shape[0]
    R = stoich.shape[0]
    dev = states.device
    cap = encoder.species_cap
    x = states
    alive = torch.ones(chunk, dtype=torch.bool, device=dev)
    t = torch.zeros(chunk, dtype=torch.float64, device=dev)
    emitted = []
    for j in range(max_steps):
        if j and j % _ALIVE_EVERY == 0 and not bool(torch.any(alive)):
            break
        props = props_fn(x)  # (chunk, R)
        diag = props.sum(dim=1)
        r = torch.rand((2, chunk), dtype=torch.float64, device=dev,
                       generator=generator)
        # exponential waiting time (StateSpace.f90:577-579); the reference
        # caps t at the budget but still takes the final jump
        safe_diag = torch.where(diag > 0, diag, 1.0)
        wait = -torch.log(torch.clamp_min(r[0], _R1_MIN)) / safe_diag
        t_next = torch.clamp_max(t + wait, t_budget)
        # categorical reaction choice by cumulative propensity scan
        # (StateSpace.f90:581-588)
        r2a = torch.minimum(r[1] * diag, diag)
        cum = torch.cumsum(props, dim=1)
        k = torch.sum(cum < r2a[:, None], dim=1)
        k = torch.clamp_max(k, R - 1)
        x_next = x + stoich[k]
        legal = torch.all((x_next >= 0) & (x_next <= cap), dim=-1)
        stepped = alive & (diag > 0)
        ok = stepped & legal
        if encoder.n_words == 1:
            emitted.append(torch.where(ok, encoder.encode(x_next), -1))
        else:
            emitted.append(torch.where(ok[:, None], x_next, -1))
        x = torch.where(ok[:, None], x_next, x)
        t = torch.where(stepped, t_next, t)
        # a walk ends on an illegal move (StateSpace.f90:594-596) or an
        # exhausted budget (loop guard :626)
        alive = ok & (t < t_budget)
    return torch.stack(emitted)


@spanned("ssa")
def ssa_extend(
    table: StateTable,
    props_fn,
    stoichiometry: np.ndarray,
    t_budget: float,
    generator: torch.Generator,
    max_steps: int,
    max_capacity: int | None,
    chunk_size: int = 1 << 16,
) -> tuple[StateTable, int]:
    """SSA-driven expansion from every current state (SSA_EXTENDER parity),
    on the generator's device.

    ``props_fn`` is a batched (m, d) -> (m, R) float64 propensity evaluator
    that keeps its input's device (``Model.propensities``).
    """
    dev = generator.device
    stoich = torch.as_tensor(np.asarray(stoichiometry), dtype=torch.int32,
                             device=dev)
    enc = table.encoder
    d = enc.n_species
    n = table.n
    # every chunk's visited states, merged once at the end: the same rows
    # in the same order as one merge per chunk (the JAX package's order),
    # which would rebuild the sorted view once per chunk
    found_keys, found_states = [], []
    for lo in range(0, n, chunk_size):
        hi = min(lo + chunk_size, n)
        visited = _ssa_walk(
            torch.as_tensor(table.states[lo:hi], device=dev),
            float(t_budget), generator, props_fn, stoich, enc, max_steps,
        )
        if enc.n_words == 1:
            keys = torch.unique(visited.reshape(-1))
            keys_np = keys[keys >= 0].cpu().numpy()
            st = enc.decode_np(keys_np)
        else:
            st = visited.reshape(-1, d)
            st = torch.unique(st[st[:, 0] >= 0], dim=0).cpu().numpy()
            keys_np = enc.encode_np(st)
        found_keys.append(keys_np)
        found_states.append(st)
    if not found_keys:
        return table, 0
    return table.merge_keys(np.concatenate(found_keys),
                            np.concatenate(found_states), max_capacity)
