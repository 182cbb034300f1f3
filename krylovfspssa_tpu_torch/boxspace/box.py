"""Masked power-of-two box state space (PyTorch port of
``krylovfspssa_tpu/boxspace/box.py``).

The projection lives inside an axis-aligned box with power-of-two extents;
a cell's flat index *is* its packed state (coordinates decode by
shift/mask), and membership is a bool mask over the box.  Consequences:

  * the CME SpMV becomes a *stencil*: state x - nu_k sits at constant flat
    offset ``-offset_k``, so each reaction contributes a shifted elementwise
    multiply — no gathers, no stored matrix;
  * dropping states = clearing mask bits; 1-step FSP expansion = dilating
    the mask by the legal-move stencil — both elementwise device ops;
  * the box grows by doubling one axis when mass approaches its face.

The geometry (axis permutation, log2 extents, offsets) is computed on the
host in numpy exactly as the JAX package computes it, so both packages
give the same box for the same model and start state.  Flat indices and
coordinate decoding run on torch tensors, on the tensors' device.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BoxSpace:
    """Geometry of the masked box: axis permutation, log2 sizes, offsets."""

    n_species: int
    #: axis_of_species[s] = box axis carrying species s (0 = slowest)
    axis_of_species: tuple[int, ...]
    #: log2 extent per axis
    log2: tuple[int, ...]
    #: (R, d) stoichiometry (species order)
    stoichiometry: np.ndarray

    # ------------------------------------------------------------------ #

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(1 << b for b in self.log2)

    @property
    def volume(self) -> int:
        return 1 << sum(self.log2)

    @property
    def strides(self) -> np.ndarray:
        sh = self.shape
        return np.cumprod((1,) + sh[::-1][:-1]).astype(np.int64)[::-1]

    @property
    def shift_of_species(self) -> np.ndarray:
        """log2(stride) of each species' axis."""
        stride_bits = np.log2(self.strides).astype(np.int64)
        return np.array(
            [stride_bits[self.axis_of_species[s]] for s in range(self.n_species)]
        )

    @property
    def bits_of_species(self) -> np.ndarray:
        return np.array(
            [self.log2[self.axis_of_species[s]] for s in range(self.n_species)]
        )

    @property
    def extents(self) -> np.ndarray:
        """Per-species extent (max count + 1)."""
        return 1 << self.bits_of_species

    @property
    def offsets(self) -> np.ndarray:
        """Flat-index change per reaction: idx(x + nu_k) = idx(x) + offsets[k]."""
        sh = self.shift_of_species
        return (self.stoichiometry.astype(np.int64) << sh[None, :]).sum(axis=1)

    # ------------------------------------------------------------------ #

    @classmethod
    def for_model(
        cls,
        stoichiometry: np.ndarray,
        initial_states: np.ndarray,
        min_log2: int = 2,
    ) -> "BoxSpace":
        """Choose the axis permutation minimizing max |offset| and initial
        extents covering the seed states."""
        stoich = np.asarray(stoichiometry, dtype=np.int64)
        d = stoich.shape[1]
        init = np.atleast_2d(np.asarray(initial_states))
        need = init.max(axis=0) + 1
        log2_sp = np.maximum(min_log2, np.ceil(np.log2(need + 1)).astype(int))

        best = None
        for perm in itertools.permutations(range(d)):
            # perm[axis] = species on that axis
            axis_of = [0] * d
            for ax, sp in enumerate(perm):
                axis_of[sp] = ax
            lg = tuple(int(log2_sp[perm[ax]]) for ax in range(d))
            cand = cls(
                n_species=d,
                axis_of_species=tuple(axis_of),
                log2=lg,
                stoichiometry=stoich,
            )
            m = np.abs(cand.offsets).max()
            if best is None or m < best[0]:
                best = (m, cand)
        return best[1]

    # ------------------------------------------------------------------ #

    def flat_index(self, states) -> torch.Tensor:
        """(n, d) states -> int64 flat cell indices (-1 if outside the box).
        A tensor argument keeps its device; anything else lands on the
        CPU."""
        if isinstance(states, torch.Tensor):
            states = states.to(torch.int64)
        else:
            states = torch.as_tensor(np.asarray(states, dtype=np.int64))
        device = states.device
        sh = torch.as_tensor(self.shift_of_species, device=device)
        ext = torch.as_tensor(self.extents, device=device)
        ok = torch.all((states >= 0) & (states < ext), dim=-1)
        idx = torch.sum(
            torch.where(ok[..., None], states, 0) << sh, dim=-1
        )
        return torch.where(ok, idx, -1)

    def species_counts(self, flat: torch.Tensor,
                       dtype=torch.float64) -> list[torch.Tensor]:
        """Decode species copy-numbers from int64 flat indices
        (shift/mask)."""
        out = []
        for s in range(self.n_species):
            sh = int(self.shift_of_species[s])
            bits = int(self.bits_of_species[s])
            out.append(((flat >> sh) & ((1 << bits) - 1)).to(dtype))
        return out

    def grow(self, species: int) -> "BoxSpace":
        """Double the extent of one species' axis."""
        ax = self.axis_of_species[species]
        lg = list(self.log2)
        lg[ax] += 1
        return dataclasses.replace(self, log2=tuple(lg))

    def shrink(self, species: int) -> "BoxSpace":
        """Halve the extent of one species' axis (caller must have checked
        that no active cell lies in the upper half)."""
        ax = self.axis_of_species[species]
        lg = list(self.log2)
        lg[ax] -= 1
        return dataclasses.replace(self, log2=tuple(lg))

    def embed(self, old: "BoxSpace", arr_old: torch.Tensor, fill=0):
        """Re-embed a flat tensor from another box into this one (on the
        tensor's device).

        Both boxes must share the axis permutation; each shared axis range
        is a prefix.  Axes that grew are padded with ``fill``; axes that
        shrank are truncated (the caller guarantees the truncated region is
        inactive).
        """
        if old.axis_of_species != self.axis_of_species:
            raise ValueError("embed needs boxes with the same axis order")
        a = arr_old.reshape(old.shape)
        a = a[tuple(slice(0, min(ns, os))
                    for ns, os in zip(self.shape, old.shape))]
        pads = [max(0, ns - os) for ns, os in zip(self.shape, old.shape)]
        if any(pads):
            out = torch.full(self.shape, fill, dtype=a.dtype, device=a.device)
            out[tuple(slice(0, s) for s in a.shape)] = a
            a = out
        return a.reshape(self.volume)
