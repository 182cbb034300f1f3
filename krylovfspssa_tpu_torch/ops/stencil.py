"""Matrix-free stencil SpMV over the masked box state space (PyTorch port
of ``krylovfspssa_tpu/ops/stencil.py``).

On the box representation (boxspace/box.py), state x - nu_k sits at constant
flat offset, so the projected CME matvec

    y[z] = sum_k a_k(z - nu_k) * x[z - nu_k]  -  diag(z) * x[z]

is R shifted elementwise multiplies plus a diagonal term: no gathers, no
stored matrix.  This replaces the reference's pointer-chasing FMATVEC
scatter loop (KrylovSolver.f90:577-607).

This module holds the plain PyTorch versions — the CPU path and the
reference the CUDA kernels are held against — and the selector.  On a CUDA
device the solve's matvec is a hand-written Hopper kernel of
``stencil_cuda.py``: ``box_stencil`` for separable propensities,
``direct_stencil`` for every other model (coupled expressions and custom
propensity callables).  Every field below is built once per box geometry
on the solve's device (the JAX package recomputes them inside each jitted
matvec, where XLA fuses them).

Under a mesh of ranks (parallel/sharded.py) each rank holds the rows
``[z0, z0+L)`` of the flat box: the fields, validity masks and diagonal
take a ``rows=(z0, L)`` argument and are built from global indices, and the
matvec, the dilation and the face test exchange halos or reduce over the
ranks (ops/halo.py).
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


def _cells(box: BoxSpace, device, rows=None) -> torch.Tensor:
    """Global flat indices of the whole box, or of the rows
    ``(z0, L)`` = cells ``[z0, z0+L)`` of one rank."""
    z0, n = (0, box.volume) if rows is None else rows
    return torch.arange(z0, z0 + n, dtype=torch.int64, device=device)


def _rows(box: BoxSpace, mesh=None) -> tuple[int, int]:
    """(z0, L) of this rank's rows under ``mesh``, else the whole box."""
    return (0, box.volume) if mesh is None else mesh.rows(box.volume)


def propensity_fields(model: Model, box: BoxSpace, dtype=torch.float64,
                      device="cpu", rows=None) -> torch.Tensor:
    """(R, vol) tensor of every reaction's propensity a_k at every cell of
    the box (at the cells of ``rows``, see :func:`_cells`, when given),
    evaluated in float64 through :func:`make_propensity_evaluator` and then
    cast to ``dtype`` — the operand of the plain direct-form stencil and of
    the diagonal (``stencil_cuda.pack_direct_stencil`` builds the kernel's
    operands from the same evaluator, one field at a time)."""
    evaluate = make_propensity_evaluator(model, box, torch.float64, device)
    flat = _cells(box, device, rows)
    return torch.stack(
        [evaluate(flat, k) for k in range(model.n_reactions)]
    ).to(dtype)


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


def dest_valid_masks(box: BoxSpace, device="cpu",
                     rows=None) -> list[torch.Tensor]:
    """``_dest_valid`` of every reaction over the whole box, or over the
    cells of ``rows`` (one rank's shard, :func:`_cells`) from their global
    indices (built once per geometry, reused by every dilation round)."""
    flat = _cells(box, device, rows)
    return [_dest_valid(box, flat, k)
            for k in range(box.stoichiometry.shape[0])]


def _axis_field(box: BoxSpace, tabs_by_species: dict, const: float, dtype,
                device="cpu", rows=None):
    """Outer product ``const * prod_s tab_s[c_s(z)]`` of per-species 1-D
    tables at the cells of ``rows`` (the whole box by default,
    :func:`_cells`), indexed from their global coordinates.  Every cell's
    products are taken in the same order whatever the rows, so a rank's
    field is the bits of the slice of the whole field."""
    flat = _cells(box, device, rows)
    arr = None
    for s, tab in tabs_by_species.items():
        sh = int(box.shift_of_species[s])
        bits = int(box.bits_of_species[s])
        t = torch.as_tensor(tab, dtype=dtype, device=device)[
            (flat >> sh) & ((1 << bits) - 1)]
        arr = t if arr is None else arr * t
    if arr is None:
        return torch.full(flat.shape, float(const), dtype=dtype,
                          device=device)
    return torch.as_tensor(const, dtype=dtype, device=device) * arr


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


def _diag_field(tables, box: BoxSpace, dtype, device, rows=None):
    """D = sum_k const_k prod_s t_{k,s}: the total outflow rate per cell
    (of the cells of ``rows`` when given)."""
    return sum(
        _axis_field(box, t_tabs, const, dtype, device, rows)
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

    props = propensity_fields(model, box, dtype, device)
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
                          device="cuda", mesh=None):
    """Pick the SpMV implementation for a solve on ``device``.

    * CUDA, separable model: the hand-written Hopper kernel ``box_stencil``
      (``stencil_cuda.make_box_stencil_matvec``) in float32 and float64.
    * CUDA, any model that ``factorize_model`` refuses (coupled
      expressions, custom propensities): the hand-written Hopper kernel
      ``direct_stencil`` (``stencil_cuda.make_direct_stencil_matvec``).
    * CPU: the plain PyTorch version (:func:`make_stencil_matvec`).
    * With ``mesh`` (a ``parallel.sharded.ShardMesh``, a mesh of one rank
      included): the halo-exchange matvec of ops/halo.py on this rank's
      rows, through the kernel ``halo_stencil`` on CUDA and its plain
      version on the CPU.  Models that do not factor, and
      ``config.use_halo=False`` (the JAX package's GSPMD stencil), are not
      ported under a mesh and raise ``NotImplementedError``.

    ``config.use_pallas`` pins TPU kernel generations in the JAX package
    and is accepted and ignored here.
    """
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    if mesh is not None:
        if not getattr(config, "use_halo", True):
            raise NotImplementedError(
                "use_halo=False (the GSPMD-partitioned stencil) is not "
                "ported to the sharded solve (ROADMAP.md Queue A, item 15)"
            )
        from .halo import make_halo_stencil_matvec

        mv = make_halo_stencil_matvec(model, box, mesh, dtype)
        if mv is None:
            raise NotImplementedError(
                f"model {model.name!r} does not factor per species; its "
                "sharded solve (the JAX package's GSPMD direct stencil) is "
                "not ported yet (ROADMAP.md Queue A, item 14)"
            )
        return mv
    if dev.type == "cpu":
        return make_stencil_matvec(model, box, dtype, dev)
    from . import stencil_cuda

    if _factored_reaction_tables(model, box) is None:
        return stencil_cuda.make_direct_stencil_matvec(model, box, dtype, dev)
    return stencil_cuda.make_box_stencil_matvec(model, box, dtype, dev)


def make_diag_fn(model: Model, box: BoxSpace, dtype=torch.float64,
                 device="cpu", rows=None):
    """Build diag(mask) -> total propensity sum_k a_k(x) per active cell
    (0 elsewhere) — the reference's DIAG column (StateSpace.f90:211-212),
    used to event-scale FSP expansion (diag * t = expected number of
    reaction firings at that state over horizon t).  With ``rows`` the
    mask is one rank's shard of those cells (:func:`_cells`)."""
    tables = _factored_reaction_tables(model, box)
    if tables is not None:
        d = _diag_field(tables, box, dtype, device, rows)
    else:
        d = sum(propensity_fields(model, box, dtype, device, rows))

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
                valid: list[torch.Tensor] | None = None,
                mesh=None) -> torch.Tensor:
    """One round of 1-step reachability: activate every legal successor of
    an active cell (the ONESTEP_EXTENDER analog, StateSpace.f90:347-396).
    ``valid`` is :func:`dest_valid_masks` of this box (of this rank's rows
    under a mesh), built here when not given.

    The predecessor of cell i under reaction k is cell i - off_k, read from
    the mask padded with H = max_k |off_k| cells on each side: zeros on one
    device (a valid predecessor never leaves the box), the neighbours' rows
    through the mask's halo under ``mesh`` (the mask is then this rank's
    rows)."""
    from .halo import halo_width

    rows = _rows(box, mesh)
    if valid is None:
        valid = dest_valid_masks(box, mask.device, rows)
    H, n = halo_width(box), rows[1]
    if mesh is None:
        left = right = torch.zeros(H, dtype=torch.bool, device=mask.device)
    else:
        left, right = mesh.exchange_halo(mask, H)
    padded = torch.cat([left, mask, right])
    out = mask
    for k in range(box.stoichiometry.shape[0]):
        src = H - int(box.offsets[k])
        out = out | (padded[src:src + n] & valid[k])
    return out


def make_dilate_fn(box: BoxSpace, device="cpu", mesh=None):
    """dilate(mask) -> one :func:`dilate_mask` round on this box (on this
    rank's rows under ``mesh``), its validity masks built once."""
    valid = dest_valid_masks(box, device, _rows(box, mesh))
    return lambda mask: dilate_mask(box, mask, valid, mesh)


def active_touches_face(box: BoxSpace, mask, mesh=None) -> np.ndarray:
    """Per-species flag: an active cell sits within the largest |nu| of the
    axis' upper face — growing that axis is warranted before expanding.
    Cells are tested from their global coordinates; with ``mesh`` the mask
    is this rank's rows and the flags are or-ed over the ranks."""
    reach = np.abs(np.asarray(box.stoichiometry)).max(axis=0)
    flat = _cells(box, mask.device, _rows(box, mesh))
    hit = []
    for s in range(box.n_species):
        if reach[s] == 0:
            hit.append(torch.zeros((), dtype=torch.bool, device=mask.device))
            continue
        sh = int(box.shift_of_species[s])
        ext = 1 << int(box.bits_of_species[s])
        co = (flat >> sh) & (ext - 1)
        hit.append(torch.any(mask & (co >= ext - int(reach[s]))))
    hit = torch.stack(hit)
    if mesh is not None:
        hit = mesh.any(hit)
    return hit.cpu().numpy()
