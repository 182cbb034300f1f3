"""The FSP state table of the table backend (PyTorch port of
``krylovfspssa_tpu/statespace/table.py``).

Replaces the reference's Brent hash table + incremental single-state
insertion (``reference/src/hash_table/HashTable.f90``,
``StateSpace.f90:136-246``) with:

* the state set as a dense (capacity, d) int32 array plus packed int64 keys;
* a sorted key view for vectorised membership (ops/operator.py searches it
  on the device, :meth:`StateTable.lookup` on the host);
* batched merges: dedup the candidates, append, re-sort;
* power-of-two capacity buckets, so device buffers (the Krylov basis, the
  operator) are re-allocated only on bucket growth.

New states are appended in order (reference parity: ADD_STATE appends at
FSP%SIZE+1) and a drop compacts preserving relative order (DROP_STATES,
StateSpace.f90:497-546): rows are the JAX package's, row for row, which the
operator indices and checkpoints depend on.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.trace import spanned
from .encoding import StateEncoder

#: padding value for the sorted-key view; larger than any valid key
_KEY_PAD = np.int64(np.iinfo(np.int64).max)


@dataclasses.dataclass
class StateTable:
    """Padded state table + sorted membership index.

    All arrays are HOST (numpy) arrays: the table is bookkeeping; the
    solver copies what the device needs once per mutation
    (``CmeSolver._operator``).  Multi-word keys have no hash index: their
    lookups search the sorted view and their merges dedup the candidates
    with torch on ``device`` (the solve's device; the CPU by default).

    ``host_index`` is the native C++ hash (native.py, HashTable.f90
    parity) mirroring key -> row for one-word keys; ``merge_keys`` filters
    and dedups candidates through it without a sort.  It is built unless
    ``native=False`` is asked for (the numpy sorted merge, the plain path)
    or the keys have several words; a failed build raises.  Tables are
    used linearly by the solver: a merge mutates the shared host index, so
    the *pre-merge* table's host lookups become stale (arrays stay
    immutable).
    """

    encoder: StateEncoder
    capacity: int
    n: int
    states: np.ndarray  #: (capacity, d) int32, rows >= n are zero
    keys: np.ndarray  #: (capacity,) int64, rows >= n are INVALID (-1)
    sorted_keys: np.ndarray  #: (capacity,) int64 ascending, padded KEY_PAD
    sorted_to_row: np.ndarray  #: (capacity,) int32
    host_index: object | None = None
    #: keep a native hash index (one-word keys); False = the sorted merge
    native: bool = True
    #: the torch device of the multi-word membership search and dedup
    device: object = "cpu"

    # ------------------------------------------------------------------ #

    @classmethod
    def from_states(
        cls,
        states,
        encoder: StateEncoder,
        capacity: int,
        max_capacity: int | None = None,
        native: bool = True,
        device="cpu",
    ) -> "StateTable":
        states = np.asarray(states, dtype=np.int32)
        if states.ndim != 2 or states.shape[1] != encoder.n_species:
            raise ValueError(f"states shape {states.shape} invalid")
        keys = encoder.encode_np(states)
        if np.any(_keys_invalid(keys, encoder)):
            raise ValueError("initial states out of encodable range")
        # dedup, preserving first-occurrence order
        order = _first_occurrences(keys, device)
        states = states[order]
        keys = keys[order]
        n = states.shape[0]
        capacity = _bucket(n, capacity, max_capacity)
        return cls._build(states, keys, n, capacity, encoder, native=native,
                          device=device)

    @classmethod
    def _build(
        cls, states_np, keys_np, n, capacity, encoder, host_index="rebuild",
        native=True, device="cpu",
    ) -> "StateTable":
        d = encoder.n_species
        W = encoder.n_words
        st = np.zeros((capacity, d), dtype=np.int32)
        st[:n] = states_np[:n]
        key_shape = (capacity,) if W == 1 else (capacity, W)
        ky = np.full(key_shape, -1, dtype=np.int64)
        ky[:n] = keys_np[:n]
        if W == 1:
            sort_src = np.where(ky >= 0, ky, _KEY_PAD)
            perm = np.argsort(sort_src, kind="stable").astype(np.int32)
        else:
            sort_src = np.where(ky[:, :1] >= 0, ky, _KEY_PAD)
            # lexicographic with word 0 major (np.lexsort: last key primary)
            perm = np.lexsort(
                tuple(sort_src[:, w] for w in range(W - 1, -1, -1))
            ).astype(np.int32)
        if host_index == "rebuild":
            host_index = None
            if native and W == 1:
                from ..native import NativeHashTable

                host_index = NativeHashTable(max(64, 2 * int(n)))
                host_index.insert(
                    keys_np[:n], np.arange(int(n), dtype=np.int32)
                )
        return cls(
            encoder=encoder,
            capacity=capacity,
            n=int(n),
            states=st,
            keys=ky,
            sorted_keys=sort_src[perm],
            sorted_to_row=perm,
            host_index=host_index,
            native=native,
            device=device,
        )

    def __reduce__(self):
        """Pickle as the rows: the native index (a C object) is rebuilt on
        loading, so a sharded solve's rank can hand back its result."""
        return (StateTable._build, (
            self.states[: self.n], self.keys[: self.n], self.n,
            self.capacity, self.encoder, "rebuild", self.native, self.device,
        ))

    # ------------------------------------------------------------------ #

    def lookup(self, query_keys) -> np.ndarray:
        """Batch membership: int64 keys -> row indices or -1: the native
        hash when the table keeps one, else a binary search of the sorted
        view (numpy for one-word keys, torch on ``device`` for several)."""
        q = np.asarray(query_keys)
        if self.encoder.n_words > 1:
            import torch

            from ..ops.operator import lookup_keys

            dev = self.device
            return lookup_keys(
                torch.as_tensor(self.sorted_keys, device=dev),
                torch.as_tensor(self.sorted_to_row, device=dev),
                torch.as_tensor(q, device=dev),
            ).cpu().numpy()
        if self.host_index is not None:
            return self.host_index.lookup(np.ascontiguousarray(q, np.int64))
        pos = np.searchsorted(self.sorted_keys, q)
        pos = np.clip(pos, 0, self.capacity - 1)
        hit = (self.sorted_keys[pos] == q) & (q >= 0)
        return np.where(hit, self.sorted_to_row[pos], -1).astype(np.int32)

    def lookup_states(self, states) -> np.ndarray:
        return self.lookup(self.encoder.encode_np(np.asarray(states)))

    def merge_keys(
        self, new_keys, new_states, max_capacity: int | None = None
    ) -> tuple["StateTable", int]:
        """Append previously-absent states; returns (table, n_added).

        ``new_keys`` may contain duplicates, invalid (-1) keys, and keys
        already present — all are filtered; the fresh ones are appended in
        the order of their first occurrence.
        """
        new_keys = np.asarray(new_keys)
        new_states = np.asarray(new_states, dtype=np.int32)
        if self.host_index is not None:
            # native path: present-filter + dedup + row assignment in one
            # C call (the index is mutated in place)
            rows, n_fresh = self.host_index.assign_fresh(new_keys, self.n)
            if n_fresh == 0:
                return self, 0
            take = rows >= 0
            order = np.argsort(rows[take], kind="stable")
            cand_keys = new_keys[take][order]
            cand_states = new_states[take][order]
            reuse_index = self.host_index
        else:
            present = self.lookup(new_keys)
            fresh = (present < 0) & ~_keys_invalid(new_keys, self.encoder)
            cand_keys = new_keys[fresh]
            cand_states = new_states[fresh]
            if cand_keys.shape[0] == 0:
                return self, 0
            order = _first_occurrences(cand_keys, self.device)
            cand_keys = cand_keys[order]
            cand_states = cand_states[order]
            reuse_index = "rebuild"
        n_new = self.n + cand_keys.shape[0]
        capacity = _bucket(n_new, self.capacity, max_capacity)
        all_states = np.concatenate([self.states[: self.n], cand_states])
        all_keys = np.concatenate([self.keys[: self.n], cand_keys])
        table = StateTable._build(
            all_states, all_keys, n_new, capacity, self.encoder,
            host_index=reuse_index, native=self.native, device=self.device,
        )
        return table, int(cand_keys.shape[0])

    @spanned("compact")
    def compact(self, keep_mask) -> tuple["StateTable", np.ndarray]:
        """Drop rows where keep_mask is False (order-preserving).

        Returns (table, old_row -> new_row int32 map with -1 for dropped).
        Capacity is kept (no shrink), so device buffers keep their size.
        """
        keep = np.asarray(keep_mask)[: self.n]
        states_np = self.states[: self.n][keep]
        keys_np = self.keys[: self.n][keep]
        remap = np.full(self.n, -1, dtype=np.int32)
        remap[keep] = np.arange(states_np.shape[0], dtype=np.int32)
        table = StateTable._build(
            states_np, keys_np, states_np.shape[0], self.capacity,
            self.encoder, native=self.native, device=self.device,
        )
        return table, remap


def _first_occurrences(keys: np.ndarray, device) -> np.ndarray:
    """Ascending indices of the first occurrence of each distinct key
    ((n,) or (n, W) int64): ``np.sort(np.unique(..., return_index=True)
    [1])``, computed with torch on ``device`` for multi-word keys."""
    if keys.ndim == 1:
        return np.sort(np.unique(keys, return_index=True)[1])
    import torch

    k = torch.as_tensor(keys, device=device)
    _, inv = torch.unique(k, dim=0, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), k.shape[0], dtype=torch.int64,
                       device=device)
    first.scatter_reduce_(0, inv, torch.arange(k.shape[0], device=device),
                          reduce="amin")
    return torch.sort(first).values.cpu().numpy()


def _keys_invalid(keys: np.ndarray, encoder: StateEncoder) -> np.ndarray:
    """Invalid-key mask for single- or multi-word host key arrays."""
    if encoder.n_words == 1:
        return keys < 0
    return keys[..., 0] < 0


def _bucket(n: int, current: int, max_capacity: int | None) -> int:
    """Smallest power-of-two bucket >= max(n, current), capped at
    ``max_capacity``; raises OverflowError when n exceeds that cap."""
    cap = max(current, 1)
    while cap < n:
        cap *= 2
    if max_capacity is not None and cap > max_capacity:
        if n > max_capacity:
            raise OverflowError(
                f"FSP size {n} exceeds the configured maximum "
                f"{max_capacity} states (reference: hard STOP on overflow, "
                "StateSpace.f90:389)"
            )
        cap = max_capacity
    return cap
