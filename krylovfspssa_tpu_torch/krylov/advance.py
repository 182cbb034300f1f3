"""Fused multi-step loops of the box and table backends (PyTorch port of
``krylovfspssa_tpu/krylov/advance.py``).

The JAX package runs the whole reference main loop (KrylovSolver.f90:206-550)
— stepping, rejection handling, dropping, expansion — inside one
``lax.while_loop`` and re-enters the host only on an event:

  * the integration reaches t_out                       (event DONE)
  * active cells touch a growable box face              (event GROW — the
    only reshape; the solver grows the box)
  * ``max_steps`` attempted steps elapsed               (event BUDGET — the
    solver may shrink the box and write a checkpoint)
  * the stepper failed (``carry.iflag != 0``)           (event FAIL)

This port keeps the segment structure and its semantics: the events, the
drop with its anti-thrash gate (``drop_inline``), the expansion by K
dilation rounds without growth (``expand_inline``) and the per-step records.
The step controller stays on the host (krylov/stepper.py: numpy scalars,
one stacked read per attempt and one per FSP evaluation, the Arnoldi
columns replayed as CUDA graphs on one card); the segment's own work stays
on the device:

  * the drop is decided and applied on the device (``torch.where``);
  * the records are a host list: every field of a record is a host value
    of the controller or of the step's one stacked read, so keeping them
    costs no copy in either direction;
  * the drop outcome, the touch test and the stepper's operator summary of
    the next step (``op_info``: active cells, largest diagonal) come back
    in ONE stacked read after a step that changed the mask; a step that
    changed nothing reads nothing (its mask touched no face after the step
    before it), and an expansion adds one read, of the event rate that
    sets its number of dilation rounds.

Under a mesh (parallel/sharded.py) the vectors are this rank's rows: every
sum over the cell axis goes through ``mesh.sum``, the largest diagonal, the
expansion's event rate and the touch flag through ``mesh.max`` (a flag is
or-ed as a maximum of 0 and 1), so every rank reads the same numbers and
takes the same branches.

The table backend's loop (:func:`make_table_advance_fn`, the second half
of this module) has the same structure on the gather-ELL operator: a drop
deactivates rows of the ``active`` mask (the host compacts the table at
the next expansion), and an expansion request ends the segment with
EVENT_EXPAND, since SSA and 1-step expansion mutate the host table.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..boxspace.box import BoxSpace
from ..config import SolverConfig
from ..models.model import Model
from ..ops.stencil import (
    _cells,
    _rows,
    expansion_rounds,
    make_diag_fn,
    make_dilate_fn,
    select_stencil_matvec,
    to_device,
)
from ..statespace.drop import _N_LEVELS
from ..utils.trace import span, spanned
from .stepper import StepCarry, make_step_fn

EVENT_NONE = 0
EVENT_DONE = 1
EVENT_GROW = 2
EVENT_BUDGET = 3
#: solver failure surfaced from the stepper (carry.iflag != 0, e.g. the
#: mxreject rejection budget was exhausted — KrylovSolver.f90:392-397)
EVENT_FAIL = 4
#: table backend: the stepper requested SSA expansion — a host-side state
#: table mutation (SSA_EXTENDER + ONESTEP_EXTENDER + operator rebuild)
EVENT_EXPAND = 5

#: per-step record fields, in the order of the columns of ``records``
RECORD_FIELDS = (
    "nstep",
    "fsp_size",
    "t_step",
    "t_new",
    "t_now",
    "m",
    "wsum",
    "err_loc",
    "advanced",
    "expanded",
    "dropped",
)

_F64 = torch.float64


class AdvanceState(NamedTuple):
    w: torch.Tensor
    mask: torch.Tensor
    carry: StepCarry
    event: int
    #: attempted steps taken in the segment
    steps: int
    #: one tuple per attempted step, its values in RECORD_FIELDS order
    records: list[tuple]
    n_drops: int
    n_expansions: int


def _face_band(box: BoxSpace, growable: tuple[int, ...], device,
               rows=None) -> torch.Tensor:
    """Cells within reach of a growable axis' upper face: for each growable
    species s with reach r = max_k |nu_ks| > 0, the cells whose coordinate
    on s is at least ext - r (of the rows ``(z0, L)`` when given)."""
    stoich = np.asarray(box.stoichiometry)
    flat = _cells(box, device, rows)
    band = torch.zeros(flat.shape, dtype=torch.bool, device=device)
    for s in growable:
        reach = int(np.abs(stoich[:, s]).max())
        if reach == 0:
            continue
        sh = int(box.shift_of_species[s])
        ext = 1 << int(box.bits_of_species[s])
        band |= ((flat >> sh) & (ext - 1)) >= ext - reach
    return band


def _touch_flags(mask: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
    """Does any active cell sit in ``band`` (:func:`_face_band`: within
    reach of a growable axis' face)?  A 0-d bool on the mask's device.
    Under a mesh it is this rank's flag: the caller or-s it over the ranks
    (``observe`` stacks it into its one ``mesh.max``)."""
    return torch.any(mask & band)


def make_advance_fn(
    model: Model,
    box: BoxSpace,
    config: SolverConfig,
    growable: tuple[int, ...],
    max_steps: int,
    dtype=torch.float64,
    device="cuda",
    mesh=None,
    *,
    matvec=None,
    diag=None,
    dilate=None,
    basis: dict | None = None,
):
    """Build advance(w, mask, carry, t_out, fsptol, krytol) -> AdvanceState.

    Bound to one box geometry, its growable axes and ``max_steps``.  The
    operator pieces ``matvec(mask, x)``, ``diag(mask)`` (float64) and
    ``dilate(mask)`` are built for ``box`` unless given (the solver passes
    the ones it caches per geometry, so a geometry's operands exist once);
    ``basis`` is handed to :func:`make_step_fn`.  With ``mesh`` the
    vectors are this rank's rows and the device is the mesh's.
    """
    if mesh is not None:
        device = mesh.device
    device = torch.device(device)
    rows = _rows(box, mesh)
    if matvec is None:
        matvec = select_stencil_matvec(model, box, config, dtype, device,
                                       mesh=mesh)
    if diag is None:
        diag = make_diag_fn(model, box, _F64, device,
                            None if mesh is None else rows)
    if dilate is None:
        dilate = make_dilate_fn(box, device, mesh)
    band = _face_band(box, growable, device, rows)
    R = model.n_reactions
    total = (lambda t: t) if mesh is None else mesh.sum
    top = (lambda t: t) if mesh is None else mesh.max
    droptol_start = config.droptol_start
    inflow_guard = config.inflow_guard
    drop_fraction = config.drop_fraction
    pressure_cells = config.drop_pressure_frac * box.volume
    levels = to_device([droptol_start / 10.0 ** i
                        for i in range(_N_LEVELS)], _F64, device)

    #: what the last stacked read said about ``seen["mask"]``: its active
    #: cells ``n``, largest diagonal ``dmax`` and face ``touch``
    seen: dict = {}

    @spanned("observe")
    def observe(mask, extra=None):
        """THE read: active cells, largest diagonal and touch flag of
        ``mask`` (reduced over ranks), stacked with the float64 scalars
        ``extra`` (already reduced); returns the values of ``extra``."""
        hit = _touch_flags(mask, band)
        n = total(torch.sum(mask).to(_F64).reshape(1))
        mx = top(torch.stack([torch.max(diag(mask)), hit.to(_F64)]))
        parts = [n, mx] if extra is None else [n, mx, extra]
        vals = torch.cat(parts).tolist()
        seen.update(mask=mask, n=int(vals[0]), dmax=vals[1],
                    touch=vals[2] > 0)
        return vals[3:]

    def op_info(mask):
        if seen.get("mask") is not mask:
            observe(mask)
        # operator-norm proxy for the scaled breakdown threshold
        return seen["n"], R, 2.0 * seen["dmax"]

    step = make_step_fn(
        lambda mask: (lambda x: matvec(mask, x)), config, op_info,
        reduce=None if mesh is None else mesh.sum, basis=basis,
        # the solver's matvec, shared with its stepwise loop: on one card
        # the Arnoldi columns replay as CUDA graphs of it
        graph_matvec=matvec,
    )

    @spanned("drop")
    def drop_inline(mask, w, dsum, rate_budget):
        """DROP_STATES as mask arithmetic on the device (StateSpace.f90:
        398-548), with the anti-thrash gate: the gross inflow into the drop
        set must stay under ``rate_budget`` unless the active cells fill
        ``drop_pressure_frac`` of the whole box (``box.volume``, all ranks'
        cells).  Returns the new mask and w and the float64 tensor
        (do, count, beta_new, dropped_mass), reduced over ranks."""
        w64 = w.to(_F64)
        inflow = matvec(mask, w).to(_F64)
        live = torch.where(mask & (w64 > 0), w64, 0.0)
        sums = total(torch.stack(
            [torch.sum(torch.where(w64 < lev, live, 0.0)) for lev in levels]))
        ok = sums < dsum
        # gather, not levels[t]: a 0-d index tensor would be read back
        first = torch.argmax(ok.to(torch.uint8)).reshape(1)
        droptol = torch.where(torch.any(ok), levels.gather(0, first)[0],
                              levels[-1])
        dmask = (w64 < droptol) & mask & ~(inflow > inflow_guard)
        gross = inflow + diag(mask) * w64
        kept = torch.where(dmask, 0.0, w)
        count, loss, dropped_mass, beta_sq = total(torch.stack([
            torch.sum(dmask).to(_F64),
            torch.sum(torch.where(dmask, torch.clamp_min(gross, 0.0), 0.0)),
            torch.sum(torch.where(dmask, w64, 0.0)),
            # the product in the vector's dtype, summed in float64
            torch.sum((kept * kept).to(_F64)),
        ]))
        do = (count > drop_fraction * seen["n"]) & (
            (loss <= rate_budget) | (seen["n"] >= pressure_cells))
        gone = dmask & do
        out = torch.stack([do.to(_F64), count, torch.sqrt(beta_sq),
                           dropped_mass])
        return mask & ~gone, torch.where(gone, 0.0, w), out

    @spanned("expand_inline")
    def expand_inline(mask, w, t_ssa):
        """SSA_EXTENDER analog (StateSpace.f90:550-630): dilate by the
        event count the reference's walks would cover in t_ssa, inside the
        current box (growth is the caller's, on a GROW event)."""
        support = mask & (w.to(_F64) > droptol_start)
        d = diag(mask)
        any_sup, lam_sup, lam_all = top(torch.stack([
            torch.any(support).to(_F64),
            torch.max(torch.where(support, d, 0.0)),
            torch.max(d),
        ])).tolist()
        lam = lam_sup if any_sup > 0 else lam_all
        k = expansion_rounds(lam, t_ssa, config.box_expand_rounds,
                             config.box_expand_rounds_max)
        for _ in range(k):
            mask = dilate(mask)
        return mask

    def advance(w, mask, carry: StepCarry, t_out, fsptol, krytol):
        t_out_abs = abs(float(t_out))
        # FSP budget rate fsp_tol/t_out scaled by the anti-thrash fraction
        rate_budget = config.drop_rate_frac * float(fsptol) / t_out_abs
        records = []
        steps = n_drops = n_exp = 0
        event = EVENT_NONE
        while event == EVENT_NONE and steps < max_steps:
            res = step(mask, w, carry, t_out, fsptol, krytol)
            w, carry = res.w, res.carry
            dropped = 0

            # ---- drop (KrylovSolver.f90:509-511) -----------------------
            if res.advanced and res.dsum > 0.0:
                mask, w, out = drop_inline(mask, w, res.dsum, rate_budget)
                do, count, beta_new, dropped_mass = observe(mask, out)
                if do:
                    dropped = int(count)
                    n_drops += 1
                    carry = carry._replace(
                        beta=np.float64(beta_new),
                        hump=np.maximum(carry.hump, beta_new),
                        # dropped mass is spent FSP budget
                        spent=carry.spent + dropped_mass,
                    )

            # ---- expansion (KrylovSolver.f90:516-534) ------------------
            if res.iexpand:
                mask = expand_inline(mask, w, res.t_ssa)
                n_exp += 1

            # ---- events ------------------------------------------------
            failed = int(carry.iflag) != 0
            done = float(carry.t_now) >= t_out_abs and not failed
            if seen.get("mask") is not mask:
                observe(mask)
            if failed:
                event = EVENT_FAIL
            elif done:
                event = EVENT_DONE
            elif seen["touch"]:
                event = EVENT_GROW

            # ---- record ------------------------------------------------
            records.append((
                int(carry.nstep), seen["n"], float(res.t_step),
                float(carry.t_new), float(carry.t_now), int(res.m_used),
                float(res.wsum), float(res.err_loc), bool(res.advanced),
                bool(res.iexpand), dropped,
            ))
            steps += 1

        return AdvanceState(
            w=w, mask=mask, carry=carry,
            event=EVENT_BUDGET if event == EVENT_NONE else event,
            steps=steps, records=records, n_drops=n_drops,
            n_expansions=n_exp,
        )

    return advance


# ------------------------------------------------------ table backend ----


class TableAdvanceState(NamedTuple):
    """A segment's outcome on the gather-ELL table backend.

    ``active`` is the soft-drop row mask: DROP_STATES deactivates rows (w
    zeroed, the matvec output masked) instead of compacting the host
    table; the host compacts at the next expansion.  ``t_ssa`` is the
    last attempted step's SSA horizon, for the expansion that EVENT_EXPAND
    asks for."""

    w: torch.Tensor
    active: torch.Tensor  # (cap,) bool soft-drop row mask
    carry: StepCarry
    event: int
    #: attempted steps taken in the segment
    steps: int
    #: one tuple per attempted step, its values in RECORD_FIELDS order
    records: list[tuple]
    n_drops: int
    t_ssa: float


def make_masked_table_step(config: SolverConfig, basis: dict | None = None,
                           seen: dict | None = None, mesh=None):
    """Single attempted step on the table backend's (op, active) pair.

    Shared by the fused loop below AND the stepwise loop (solver.py) so
    that both run the same matvec, ``torch.where(active, spmv(op, x), 0)``,
    with the active-row count as the cost model's n.  (The JAX package
    found that a bare ``spmv`` in one loop and the masked form in the
    other round differently at the ulp level — enough to flip a step size
    and part the loops.)

    ``op_info`` reads the active rows and the largest active diagonal
    (the operator-norm proxy of the scaled breakdown threshold) in one
    stacked read, and only for an (op, active) pair it has not seen:
    ``seen`` holds the last pair's numbers, and a caller that already
    knows them (the fused loop's drop) stores them there.  ``basis`` is
    handed to :func:`make_step_fn`.  With ``mesh`` (parallel/sharded.py)
    ``op``, ``active`` and the vectors are this rank's rows: the matvec is
    ``sharded_matvec`` (x all-gathered) and every sum and maximum over the
    rows runs over the ranks.
    """
    from ..ops.spmv import operator_nreactions, spmv

    if seen is None:
        seen = {}
    if mesh is None:
        matvec = spmv
    else:
        from ..parallel.sharded import sharded_matvec

        matvec = sharded_matvec(mesh)

    def masked_matvec(oa):
        op, active = oa

        def mv(x):
            return torch.where(active, matvec(op, x), 0.0)

        return mv

    def op_info(oa):
        op, active = oa
        if seen.get("op") is not op or seen.get("active") is not active:
            with span("observe"):
                nd = torch.stack([
                    torch.sum(active).to(_F64),
                    torch.max(torch.where(active, op.diag, 0.0)).to(_F64),
                ])
                if mesh is not None:
                    nd = torch.stack([mesh.sum(nd[0]), mesh.max(nd[1])])
                n, dmax = nd.tolist()
            seen.update(op=op, active=active, n=int(n), dmax=dmax)
        return seen["n"], operator_nreactions(op), 2.0 * seen["dmax"]

    return make_step_fn(masked_matvec, config, op_info,
                        reduce=None if mesh is None else mesh.sum,
                        basis=basis)


def make_table_advance_fn(
    config: SolverConfig,
    max_steps: int,
    max_states: int | None = None,
    basis: dict | None = None,
    mesh=None,
):
    """Fused multi-step loop of the table (gather-ELL or pencil) backend.

    Builds ``advance(op, w, active, carry, t_out, fsptol, krytol)`` that
    runs up to ``max_steps`` attempted steps and returns to the host on:

      * t_out reached                                  (EVENT_DONE)
      * SSA expansion requested by the FSP criterion   (EVENT_EXPAND — the
        state-table mutation is host-side by design)
      * stepper failure (iflag != 0)                   (EVENT_FAIL)
      * ``max_steps`` elapsed                          (EVENT_BUDGET)

    Probability-mass dropping (KrylovSolver.f90:509-511, DROP_STATES
    StateSpace.f90:398-548) runs as a soft drop on the device: rows are
    deactivated (w zeroed, matvec output masked), which is the same as
    removing the state from the projection — inflow into a deactivated
    row is discarded and its outflow vanishes with x=0.  The operator is
    fixed between expansion events.  ``basis`` is handed to
    :func:`make_step_fn` (the solver shares one across capacity buckets).
    With ``mesh`` the operator, ``w`` and ``active`` are this rank's rows
    (:func:`make_masked_table_step`); the drop's sums, counts and maxima
    run over the ranks, so every rank takes the same decision.
    """
    from ..ops.spmv import spmv

    seen: dict = {}
    step = make_masked_table_step(config, basis, seen, mesh)
    if mesh is None:
        matvec = spmv
        total = top = (lambda t: t)
    else:
        from ..parallel.sharded import sharded_matvec

        matvec, total, top = sharded_matvec(mesh), mesh.sum, mesh.max
    inflow_guard = config.inflow_guard
    drop_fraction = config.drop_fraction
    levels = [config.droptol_start / 10.0 ** i for i in range(_N_LEVELS)]

    @spanned("drop")
    def drop_inline(op, active, w, dsum, rate_budget, carry):
        """DROP_STATES as row-mask arithmetic on the device: the largest
        droptol level whose below-threshold mass fits in dsum, rows below
        it deactivated unless the inflow guard keeps them, committed only
        when more than drop_fraction of the active rows would go AND the
        drop set's gross inflow rate fits ``rate_budget`` (the anti-thrash
        gate, config.drop_rate_frac), or under memory pressure against
        ``max_states``.  One stacked read brings back the outcome and the
        next step's operator summary."""
        n_active = seen["n"]
        w64 = w.to(_F64)
        inflow = torch.where(active, matvec(op, w), 0.0).to(_F64)
        live = torch.where(active & (w64 > 0), w64, 0.0)
        sums = total(torch.stack(
            [torch.sum(torch.where(w64 < lev, live, 0.0)) for lev in levels]))
        lv = torch.tensor(levels, dtype=_F64, device=w.device)
        ok = sums < dsum
        droptol = torch.where(torch.any(ok),
                              lv[torch.argmax(ok.to(torch.uint8))], lv[-1])
        dmask = (w64 < droptol) & active & ~(inflow > inflow_guard)
        # anti-thrash gate on the GROSS inflow into the drop set: the
        # per-state guard tests the net derivative (A w)_i, ~0 for a
        # quasi-equilibrated boundary state that still carries throughput
        gross_in = inflow + (op.diag * w).to(_F64)
        count, loss_rate = total(torch.stack([
            torch.sum(dmask).to(_F64),
            torch.sum(torch.where(dmask, torch.clamp_min(gross_in, 0.0),
                                  0.0)),
        ]))
        gate = loss_rate <= rate_budget
        if max_states is not None and (
                n_active >= config.drop_pressure_frac * max_states):
            # memory-pressure escape (config.drop_pressure_frac)
            gate = torch.ones_like(gate)
        do = (count > drop_fraction * n_active) & gate
        gone = dmask & do
        active_new = active & ~gone
        w_new = torch.where(gone, 0.0, w)
        beta_sq, dropped, n_new = total(torch.stack([
            torch.sum((w_new * w_new).to(_F64)),
            torch.sum(torch.where(dmask, w64, 0.0)),
            torch.sum(active_new).to(_F64),
        ]))
        out = torch.stack([
            do.to(_F64), count, torch.sqrt(beta_sq), dropped, n_new,
            top(torch.max(torch.where(active_new, op.diag, 0.0)).to(_F64)),
        ]).tolist()
        do, count, beta_new, dropped_mass, n_new, dmax = out
        seen.update(op=op, active=active_new, n=int(n_new), dmax=dmax)
        if not do:
            return active_new, w_new, carry, 0
        carry = carry._replace(
            beta=np.float64(beta_new),
            hump=np.maximum(carry.hump, beta_new),
            spent=carry.spent + dropped_mass,
        )
        return active_new, w_new, carry, int(count)

    def advance(op, w, active, carry: StepCarry, t_out, fsptol, krytol):
        t_out_abs = abs(float(t_out))
        # FSP budget rate fsp_tol/t_out (FERRORBOUND slope,
        # KrylovSolver.f90:609-616) scaled by the anti-thrash fraction
        rate_budget = config.drop_rate_frac * float(fsptol) / t_out_abs
        records = []
        steps = n_drops = 0
        event = EVENT_NONE
        res = None
        while event == EVENT_NONE and steps < max_steps:
            res = step((op, active), w, carry, t_out, fsptol, krytol)
            w, carry = res.w, res.carry
            dropped = 0

            # ---- inline soft drop (KrylovSolver.f90:509-511) -----------
            if res.advanced and res.dsum > 0.0:
                active, w, carry, dropped = drop_inline(
                    op, active, w, res.dsum, rate_budget, carry)
                n_drops += dropped > 0

            # ---- events ------------------------------------------------
            failed = int(carry.iflag) != 0
            done = float(carry.t_now) >= t_out_abs and not failed
            if failed:
                event = EVENT_FAIL
            elif done:
                event = EVENT_DONE
            elif res.iexpand:
                event = EVENT_EXPAND

            # ---- record ------------------------------------------------
            records.append((
                int(carry.nstep), seen["n"], float(res.t_step),
                float(carry.t_new), float(carry.t_now), int(res.m_used),
                float(res.wsum), float(res.err_loc), bool(res.advanced),
                bool(res.iexpand), dropped,
            ))
            steps += 1

        return TableAdvanceState(
            w=w, active=active, carry=carry,
            event=EVENT_BUDGET if event == EVENT_NONE else event,
            steps=steps, records=records, n_drops=n_drops,
            t_ssa=float(res.t_ssa) if res else 0.0,
        )

    return advance
