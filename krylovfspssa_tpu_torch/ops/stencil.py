"""Matrix-free stencil SpMV over the masked box state space (PyTorch port
of ``krylovfspssa_tpu/ops/stencil.py``).

On the box representation (boxspace/box.py), state x - nu_k sits at constant
flat offset, so the projected CME matvec

    y[z] = sum_k a_k(z - nu_k) * x[z - nu_k]  -  diag(z) * x[z]

is R shifted elementwise multiplies plus a diagonal term: no gathers, no
stored matrix.  This replaces the reference's pointer-chasing FMATVEC
scatter loop (KrylovSolver.f90:577-607).

This module holds the plain PyTorch versions — the CPU path and the
reference the CUDA kernel is held against — and the selector.  On a CUDA
device the solve's matvec is the hand-written Hopper kernel of
``stencil_cuda.py``.  Every field below is built once per box geometry on
the solve's device (the JAX package recomputes them inside each jitted
matvec, where XLA fuses them).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..boxspace.box import BoxSpace
from ..models.model import Model


def make_propensity_evaluator(
    model: Model, box: BoxSpace, dtype=torch.float64, device="cpu"
) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """Returns a(flat_cells, k) -> propensity of reaction k at those cells.

    For expression models the compiled AST is evaluated directly on the
    decoded coordinate tensors; custom propensities get a stacked (n, d)
    state tensor (parity with CUSTOMPROP).
    """
    params = torch.as_tensor(model.parameters, dtype=dtype, device=device)

    if model.custom_propensity is None:
        fns = model._ensure_compiled()
        names = list(model.species_names)
        pnames = list(model.parameter_names)

        def evaluate(flat, k):
            coords = box.species_counts(flat, dtype)
            env = {name: coords[s] for s, name in enumerate(names)}
            env.update({name: params[j] for j, name in enumerate(pnames)})
            return torch.as_tensor(
                fns[k](env), dtype=dtype, device=flat.device
            ).broadcast_to(flat.shape)

    else:

        def evaluate(flat, k):
            states = torch.stack(box.species_counts(flat, dtype), dim=-1)
            return torch.as_tensor(
                model.custom_propensity(states, k, params),
                dtype=dtype, device=flat.device,
            ).broadcast_to(flat.shape)

    return evaluate


def _dest_valid(box: BoxSpace, flat: torch.Tensor, k: int) -> torch.Tensor:
    """Cells z whose predecessor z - nu_k lies inside the box."""
    stoich = np.asarray(box.stoichiometry)
    ok = torch.ones(flat.shape, dtype=torch.bool, device=flat.device)
    for s in range(box.n_species):
        nu = int(stoich[k, s])
        if nu == 0:
            continue
        sh = int(box.shift_of_species[s])
        bits = int(box.bits_of_species[s])
        co = (flat >> sh) & ((1 << bits) - 1)
        pred = co - nu
        ok = ok & (pred >= 0) & (pred < (1 << bits))
    return ok


def dest_valid_masks(box: BoxSpace, device="cpu") -> list[torch.Tensor]:
    """``_dest_valid`` of every reaction over the whole box (built once per
    geometry, reused by every dilation round)."""
    flat = torch.arange(box.volume, dtype=torch.int64, device=device)
    return [_dest_valid(box, flat, k)
            for k in range(box.stoichiometry.shape[0])]


def _axis_field(box: BoxSpace, tabs_by_species: dict, const: float, dtype,
                device="cpu"):
    """Broadcast outer product of per-species 1-D tables over the box,
    flattened to (vol,)."""
    shape = box.shape
    nd = len(shape)
    arr = None
    for s, tab in tabs_by_species.items():
        ax = box.axis_of_species[s]
        t = torch.as_tensor(tab, dtype=dtype, device=device).reshape(
            (1,) * ax + (shape[ax],) + (1,) * (nd - ax - 1)
        )
        arr = t if arr is None else arr * t
    c = torch.as_tensor(const, dtype=dtype, device=device)
    if arr is None:
        return torch.full((box.volume,), float(const), dtype=dtype,
                          device=device)
    return (c * arr).broadcast_to(shape).reshape(box.volume)


def _factored_reaction_tables(model: Model, box: BoxSpace):
    """Per-reaction (const, u_tabs, t_tabs) from the propensity
    factorization, or None.  ``u_tabs[s]`` is the *shifted* source-factor
    table with FSP validity baked in (zero where the source coordinate
    leaves the box); ``t_tabs[s]`` the plain factor table (for the
    diagonal).  Only species that are referenced or moved by the reaction
    appear."""
    from ..models.factorize import (
        factor_table,
        factorize_model,
        shifted_factor_table,
    )

    facts = factorize_model(model)
    if facts is None:
        return None
    stoich = np.asarray(box.stoichiometry)
    exts = np.asarray(box.extents)
    out = []
    for k, fz in enumerate(facts):
        relevant = set(fz.factors) | {
            int(s) for s in np.nonzero(stoich[k])[0]
        }
        u_tabs = {
            s: shifted_factor_table(
                fz, s, int(exts[s]), int(stoich[k, s]), model
            )
            for s in relevant
        }
        t_tabs = {
            s: factor_table(fz, s, int(exts[s]), model) for s in fz.factors
        }
        out.append((fz.const, u_tabs, t_tabs))
    return out


def _diag_field(tables, box: BoxSpace, dtype, device):
    """D = sum_k const_k prod_s t_{k,s}: the total outflow rate per cell."""
    return sum(
        _axis_field(box, t_tabs, const, dtype, device)
        for const, _, t_tabs in tables
    )


def make_stencil_matvec(model: Model, box: BoxSpace, dtype=torch.float64,
                        device="cpu"):
    """Build matvec(mask, x) -> y for the current box geometry (the plain
    PyTorch version).

    ``mask`` is the FSP membership mask (bool, flat) and x a flat vector.

    For separable propensities (models/factorize.py) the matvec runs in
    *destination form*: y[z] = sum_k U_k[z] * x[z - nu_k] - D[z] * x[z]
    with U_k the shifted-factor outer-product field (validity baked in) —
    one multiply-add per reaction per cell.  Non-separable models use
    direct evaluation (reference FMATVEC semantics either way,
    KrylovSolver.f90:577-607).
    """
    offsets = [int(o) for o in box.offsets]
    R = model.n_reactions

    tables = _factored_reaction_tables(model, box)
    if tables is not None:
        diag = _diag_field(tables, box, dtype, device)
        fields = [_axis_field(box, u_tabs, const, dtype, device)
                  for const, u_tabs, _ in tables]

        def matvec(mask, x):
            xm = torch.where(mask, x, 0)
            y = -diag * xm
            for k in range(R):
                y = y + fields[k] * torch.roll(xm, offsets[k])
            return torch.where(mask, y, 0)

        return matvec

    evaluate = make_propensity_evaluator(model, box, dtype, device)
    flat = torch.arange(box.volume, dtype=torch.int64, device=device)
    props = [evaluate(flat, k) for k in range(R)]
    diag = sum(props)
    valid = dest_valid_masks(box, device)

    def matvec(mask, x):
        xm = torch.where(mask, x, 0)
        y = -diag * xm
        for k in range(R):
            rolled = torch.roll(props[k] * xm, offsets[k])
            y = y + torch.where(valid[k], rolled, 0)
        return torch.where(mask, y, 0)

    return matvec


def select_stencil_matvec(model: Model, box: BoxSpace, config, dtype,
                          device="cuda"):
    """Pick the SpMV implementation for a solve on ``device``.

    * CUDA, separable model: the hand-written Hopper kernel
      (``stencil_cuda.make_box_stencil_matvec``) in float32 and float64.
    * CUDA, non-separable or custom-propensity model: ``NotImplementedError``
      (that needs kernel B5 of ROADMAP.md Queue B, not ported yet).
    * CPU: the plain PyTorch version (:func:`make_stencil_matvec`).

    ``config.use_pallas`` pins TPU kernel generations in the JAX package
    and is accepted and ignored here.
    """
    del config  # use_pallas has no meaning on this backend
    dev = torch.device(device)
    if dev.type == "cpu":
        return make_stencil_matvec(model, box, dtype, dev)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    if _factored_reaction_tables(model, box) is None:
        raise NotImplementedError(
            f"model {model.name!r} is not separable; its stencil on a GPU "
            "needs the non-separable kernel (ROADMAP.md Queue B, B5), "
            "which is not ported yet"
        )
    from .stencil_cuda import make_box_stencil_matvec

    return make_box_stencil_matvec(model, box, dtype, dev)


def make_diag_fn(model: Model, box: BoxSpace, dtype=torch.float64,
                 device="cpu"):
    """Build diag(mask) -> total propensity sum_k a_k(x) per active cell
    (0 elsewhere) — the reference's DIAG column (StateSpace.f90:211-212),
    used to event-scale FSP expansion (diag * t = expected number of
    reaction firings at that state over horizon t)."""
    tables = _factored_reaction_tables(model, box)
    if tables is not None:
        d = _diag_field(tables, box, dtype, device)
    else:
        evaluate = make_propensity_evaluator(model, box, dtype, device)
        flat = torch.arange(box.volume, dtype=torch.int64, device=device)
        d = sum(evaluate(flat, k) for k in range(model.n_reactions))

    def diag(mask):
        return torch.where(mask, d, 0)

    return diag


def expansion_rounds(lam: float, t_ssa: float, rounds_min: int,
                     rounds_max: int) -> int:
    """Dilation count matching the reference SSA extender's reach: the
    number of reaction events in time t at rate lam is Poisson(lam*t);
    cover its upper tail with ev + 3*sqrt(ev) + 1 shells (the FSP
    criterion loop remains the backstop for the truncated tail)."""
    ev = max(float(t_ssa), 0.0) * max(float(lam), 0.0)
    k = math.ceil(ev + 3.0 * math.sqrt(ev)) + 1.0
    return int(min(max(k, rounds_min), rounds_max))


def dilate_mask(box: BoxSpace, mask: torch.Tensor,
                valid: list[torch.Tensor] | None = None) -> torch.Tensor:
    """One round of 1-step reachability: activate every legal successor of
    an active cell (the ONESTEP_EXTENDER analog, StateSpace.f90:347-396).
    ``valid`` is :func:`dest_valid_masks` of this box, built here when
    not given."""
    if valid is None:
        valid = dest_valid_masks(box, mask.device)
    out = mask
    for k in range(box.stoichiometry.shape[0]):
        rolled = torch.roll(mask, int(box.offsets[k]))
        out = out | (rolled & valid[k])
    return out


def active_touches_face(box: BoxSpace, mask) -> np.ndarray:
    """Per-species flag: an active cell sits within the largest |nu| of the
    axis' upper face — growing that axis is warranted before expanding."""
    m = torch.as_tensor(mask).reshape(box.shape)
    stoich = np.asarray(box.stoichiometry)
    out = np.zeros(box.n_species, dtype=bool)
    for s in range(box.n_species):
        reach = int(np.abs(stoich[:, s]).max())
        if reach == 0:
            continue
        ax = box.axis_of_species[s]
        ext = box.shape[ax]
        sl = [slice(None)] * len(box.shape)
        sl[ax] = slice(ext - reach, ext)
        out[s] = bool(m[tuple(sl)].any())
    return out
