"""Packed int64 state keys (PyTorch port of
``krylovfspssa_tpu/statespace/encoding.py``).

The reference maps a state x to a 150-digit big-integer key
``2 + sum_k x_k * (B+1)^(k-1)`` with B = MAXNUMBERMOLECULES = 10000
(``reference/src/hash_table/HashTable.f90:39-59``).  Here the mixed-radix
key is packed into int64 words with *power-of-two* per-species radixes, so
encode/decode are shifts and masks:

    key(x) = sum_k x_k << shift_k,        shift_k = k * bits_per_species

A state is *encodable* iff every component is in [0, cap] with
cap = 2**bits_per_species - 1.  When the packing does not fit in one
62-bit word (more than 4 species at the reference cap of 10000), keys
become **multi-word**: shape (..., n_words) int64 with at most
``62 // bits`` species per word (ops/operator.py:lookup_keys searches them
lexicographically).

torch has no uint64: every shift stays below bit 62 of a signed int64, so
the keys are the JAX package's int64 values bit for bit.  Sentinel: key -1
(all words -1) is "invalid / empty slot"; valid words are >= 0, so the
(lexicographic) sort order of keys is the order of states.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: keys are signed int64; keep a sign bit plus headroom
_MAX_TOTAL_BITS = 62

#: sentinel for "no state" (sorts after every valid key once the sorted
#: view replaces it by the pad value, statespace/table.py)
INVALID_KEY = np.int64(-1)


@dataclasses.dataclass(frozen=True)
class StateEncoder:
    """Bijective packing of bounded nonnegative integer states into one or
    more int64 key words.

    ``n_words == 1`` keeps keys as plain (n,) int64; wider models get
    (n, n_words) keys: species s lives in word ``s // species_per_word`` at
    shift ``(s % species_per_word) * bits``.  ``encode``/``decode`` take
    and return tensors on the input's device; ``encode_np``/``decode_np``
    are their host (numpy) mirrors for the table bookkeeping.
    """

    n_species: int
    bits_per_species: int
    n_words: int = 1

    @classmethod
    def for_model(
        cls, n_species: int, max_molecules: int = 10_000
    ) -> "StateEncoder":
        bits = int(np.ceil(np.log2(max_molecules + 1)))
        per_word = max(1, _MAX_TOTAL_BITS // bits)
        n_words = -(-n_species // per_word)
        return cls(
            n_species=n_species, bits_per_species=bits, n_words=n_words
        )

    @property
    def species_cap(self) -> int:
        """Largest representable molecule count per species."""
        return (1 << self.bits_per_species) - 1

    @property
    def species_per_word(self) -> int:
        return max(1, _MAX_TOTAL_BITS // self.bits_per_species)

    @property
    def word_of_species(self) -> np.ndarray:
        return (
            np.arange(self.n_species, dtype=np.int64) // self.species_per_word
        )

    @property
    def shifts(self) -> np.ndarray:
        """Shift of each species within its own key word."""
        return (
            np.arange(self.n_species, dtype=np.int64) % self.species_per_word
        ) * self.bits_per_species

    # ---------------------------------------------------------- torch ---

    def keys_valid(self, keys: torch.Tensor) -> torch.Tensor:
        """(...,) bool: a key is valid iff its words are >= 0 (invalid keys
        have every word -1)."""
        if self.n_words == 1:
            return keys >= 0
        return keys[..., 0] >= 0

    def invalidate(self, keys: torch.Tensor, cond) -> torch.Tensor:
        """Set keys to INVALID_KEY where ``cond`` holds."""
        if self.n_words == 1:
            return torch.where(cond, int(INVALID_KEY), keys)
        return torch.where(cond[..., None], int(INVALID_KEY), keys)

    def encode(self, states) -> torch.Tensor:
        """(n, d) integer states -> (n,) [or (n, n_words)] int64 keys on
        the states' device; out-of-range states map to INVALID_KEY (the
        reference's out-of-bounds key-0 flag, HashTable.f90:44-52)."""
        states = torch.as_tensor(states).to(torch.int64)
        dev = states.device
        shifts = torch.as_tensor(self.shifts, device=dev)
        valid = torch.all((states >= 0) & (states <= self.species_cap),
                          dim=-1)
        safe = torch.where(valid[..., None], states, 0) << shifts
        if self.n_words == 1:
            key = torch.sum(safe, dim=-1)
            return torch.where(valid, key, int(INVALID_KEY))
        wos = self.word_of_species
        key = torch.stack(
            [safe[..., torch.as_tensor(wos == w, device=dev)].sum(dim=-1)
             for w in range(self.n_words)],
            dim=-1,
        )
        return torch.where(valid[..., None], key, int(INVALID_KEY))

    def decode(self, keys: torch.Tensor) -> torch.Tensor:
        """keys -> (n, d) int32 states (invalid keys -> zeros)."""
        keys = torch.as_tensor(keys).to(torch.int64)
        dev = keys.device
        shifts = torch.as_tensor(self.shifts, device=dev)
        if self.n_words == 1:
            comps = (keys[..., None] >> shifts) & self.species_cap
            valid = keys >= 0
        else:
            wos = torch.as_tensor(self.word_of_species, device=dev)
            comps = (keys[..., wos] >> shifts) & self.species_cap
            valid = keys[..., 0] >= 0
        return torch.where(valid[..., None], comps, 0).to(torch.int32)

    # ---------------------------------------------------------- numpy ---

    def encode_np(self, states: np.ndarray) -> np.ndarray:
        """Host (numpy) mirror of :meth:`encode`, for the host-side table
        and expansion bookkeeping."""
        states = np.asarray(states, dtype=np.int64)
        shifts = self.shifts
        valid = np.all((states >= 0) & (states <= self.species_cap), axis=-1)
        safe = np.where(valid[..., None], states, 0) << shifts
        if self.n_words == 1:
            key = safe.sum(axis=-1)
            return np.where(valid, key, INVALID_KEY)
        wos = self.word_of_species
        key = np.stack(
            [safe[..., wos == w].sum(axis=-1) for w in range(self.n_words)],
            axis=-1,
        )
        return np.where(valid[..., None], key, INVALID_KEY)

    def decode_np(self, keys: np.ndarray) -> np.ndarray:
        """Host (numpy) mirror of :meth:`decode`."""
        keys = np.asarray(keys, dtype=np.int64)
        shifts = self.shifts
        mask = np.int64(self.species_cap)
        if self.n_words == 1:
            comps = (keys[..., None] >> shifts) & mask
            valid = keys >= 0
        else:
            comps = (keys[..., self.word_of_species] >> shifts) & mask
            valid = keys[..., 0] >= 0
        return np.where(valid[..., None], comps, 0).astype(np.int32)

    def reaction_deltas(self, stoichiometry: np.ndarray) -> np.ndarray:
        """Per-reaction key increments: key(x + nu_r) = key(x) + delta_r
        (per word) whenever both states are encodable — the packed-radix
        analog of the reference's REACTIONKEY/RKEYSIGN
        (StateSpace.f90:635-669)."""
        stoich = np.asarray(stoichiometry, dtype=np.int64)
        shifted = stoich << self.shifts[None, :]
        if self.n_words == 1:
            return shifted.sum(axis=1)
        wos = self.word_of_species
        return np.stack(
            [shifted[:, wos == w].sum(axis=1) for w in range(self.n_words)],
            axis=1,
        )
