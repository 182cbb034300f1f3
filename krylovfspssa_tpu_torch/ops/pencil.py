"""Pencil-structured CME operator of the table backend (PyTorch port of
``krylovfspssa_tpu/ops/pencil.py``).

The gather-ELL matvec (ops/spmv.py) gathers one element per (state,
reaction).  The pencil layout groups the state set into 128-lane rows:
pick one "lane species" L (by default the one of largest extent), group
the states by their other coordinates (the "base"), and lay each base's
L-range along one or more 128-lane rows ("pencils"), padded to the lane
width.  The matvec then needs

  * one whole-row gather per (row, reaction): about n/128 row indices,
    not n*R element indices;
  * a static lane shift (two contiguous slices) per reaction;
  * streamed per-cell propensity fields.

The JAX package picks this form on TPU, where XLA serialises per-element
gathers; ``"auto"`` takes the gather-ELL operator on CPU and GPU there and
here, so on CUDA the pencil runs only when asked for
(``config.table_operator="pencil"``).  Membership is exact FSP (the
principal submatrix A_J): padding cells are not members, a predecessor
field is zero where the predecessor cell is absent, and the output is
masked to member cells: the math of ops/operator.py.

The layout and the source-row tables are host numpy (:func:`host_index_tables`,
the JAX functions' arithmetic); the per-cell fields are built on the
solve's device by :func:`make_pencil_operator_builder`, a bounded number of
cells at a time, and the matvec is a few torch ops on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LANES = 128

#: cells whose propensities the device builder evaluates at a time: each
#: evaluation makes (cells, R) float64 temporaries, R + 1 times per chunk
_CELL_CHUNK = 1 << 18

#: number of :func:`pencil_matvec` calls (a plain counter a run resets and
#: reads to show that its matvecs went through the pencil operator)
CALLS = 0


class PencilLayout(NamedTuple):
    """Host-side layout descriptor (numpy; rebuilt per state-set change)."""

    lane_species: int
    #: (nbases, d-1) int32 sorted unique base coordinates
    bases: np.ndarray
    #: (nbases,) int32 first row of each base
    base_row_start: np.ndarray
    #: (nbases,) int32 number of 128-lane rows of each base
    base_nrows: np.ndarray
    #: (rows,) int32 base index of each row
    row_base: np.ndarray
    #: (rows,) int32 lane-block index of each row within its base
    row_block: np.ndarray
    #: (n,) int64 flat cell slot of each table row (row*128 + lane)
    slot_of_state: np.ndarray
    #: (rows, LANES) bool member-cell mask
    mask: np.ndarray
    n_rows: int
    n_states: int

    @property
    def n_cells(self) -> int:
        return self.n_rows * LANES


def build_pencil_layout(
    states: np.ndarray, lane_species: int | None = None
) -> PencilLayout:
    """Group the state set into lane-aligned pencils.

    Args:
      states: (n, d) int32 active states (no padding rows).
      lane_species: coordinate laid along lanes; default = the species
        with the largest extent (fewest rows, densest lanes).
    """
    states = np.asarray(states)
    n, d = states.shape
    if lane_species is None:
        lane_species = int(np.argmax(states.max(axis=0)))
    others = [s for s in range(d) if s != lane_species]
    base_coords = states[:, others]
    M = states[:, lane_species].astype(np.int64)

    bases, inv = np.unique(base_coords, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    nb = len(bases)
    mmax = np.zeros(nb, dtype=np.int64)
    np.maximum.at(mmax, inv, M)
    base_nrows = ((mmax + LANES) // LANES).astype(np.int32)
    base_row_start = np.zeros(nb, dtype=np.int32)
    np.cumsum(base_nrows[:-1], out=base_row_start[1:])
    n_rows = int(base_nrows.sum())

    row_base = np.repeat(np.arange(nb, dtype=np.int32), base_nrows)
    row_block = (np.arange(n_rows, dtype=np.int32)
                 - base_row_start[row_base]).astype(np.int32)

    slot = ((base_row_start[inv].astype(np.int64) + (M // LANES)) * LANES
            + (M % LANES)).astype(np.int64)
    mask = np.zeros(n_rows * LANES, dtype=bool)
    mask[slot] = True

    return PencilLayout(
        lane_species=int(lane_species),
        bases=bases.astype(np.int32),
        base_row_start=base_row_start,
        base_nrows=base_nrows,
        row_base=row_base,
        row_block=row_block,
        slot_of_state=slot,
        mask=mask.reshape(n_rows, LANES),
        n_rows=n_rows,
        n_states=n,
    )


def _lookup_bases(layout: PencilLayout, queries: np.ndarray) -> np.ndarray:
    """(m, d-1) base coords -> base index or -1 (host, vectorized)."""
    nb, dm1 = layout.bases.shape
    # structured view for a lexicographic searchsorted
    key = np.zeros(nb, dtype=np.dtype([(f"c{j}", np.int32)
                                       for j in range(dm1)]))
    q = np.zeros(len(queries), dtype=key.dtype)
    for j in range(dm1):
        key[f"c{j}"] = layout.bases[:, j]
        q[f"c{j}"] = queries[:, j]
    pos = np.searchsorted(key, q)
    pos = np.clip(pos, 0, nb - 1)
    hit = key[pos] == q
    return np.where(hit, pos, -1).astype(np.int64)


class PencilOperator:
    """Device tensors of the pencil-form projected CME generator.

    Per-cell fields are flat (cells,), so the solver's vector machinery
    (masked step, inline drop, norms) treats a pencil solve like a table
    solve; the matvec reshapes to (rows, LANES) itself:

        y2d = -diag * x2d
        for k:  y2d += pred_prop[k] * lane_shift([x2d[src_a[k]] |
                                                  x2d[src_b[k]]], shift[k])
        y2d *= mask

    ``shifts`` (the lane species' stoichiometry per reaction) are Python
    ints: each value is a different pair of slices.

    Fields: diag (cells,) total outflow at member cells, 0 at padding;
    mask (cells,) int8 member mask; pred_prop (R, cells) a_k(pred cell),
    or 0 where the predecessor is absent or illegal; src_a / src_b
    (R, rows) int32 source rows of the high and low lanes (-1 reads
    zeros); n: 0-d int32 member-state count.  ``pair_rows`` is derived
    from src_a and src_b: the matvec's one gather per reaction.
    """

    def __init__(self, diag, mask, pred_prop, src_a, src_b, shifts, n):
        self.diag = diag
        self.mask = mask
        self.pred_prop = pred_prop
        self.src_a = src_a
        self.src_b = src_b
        self.shifts = tuple(int(s) for s in shifts)
        self.n = n
        rows = src_a.shape[-1]
        #: (R, 2*rows) int64: each output row's two source rows, src_a then
        #: src_b, with -1 mapped to the zero row ``rows`` that
        #: :func:`pencil_matvec` appends to x; a gather by it is the row
        #: pair [ga | gb] of every row, contiguous
        self.pair_rows = torch.stack([
            torch.where(src_a >= 0, src_a, rows),
            torch.where(src_b >= 0, src_b, rows),
        ], dim=-1).reshape(src_a.shape[0], 2 * rows).long()

    def tensors(self) -> tuple:
        """The operator's tensors (every field but ``shifts``)."""
        return (self.diag, self.mask, self.pred_prop, self.src_a,
                self.src_b, self.n, self.pair_rows)


def _lane_shift(z, s: int):
    """Lane l of the result is lane l - s of the row pair z = [ga | gb]
    (ga the high-lane source block for s > 0, the low one for s < 0)."""
    if s >= 0:
        return z[:, LANES - s:2 * LANES - s]
    return z[:, -s:LANES - s]


def _check_shift(s: int) -> int:
    if abs(s) >= LANES:
        raise ValueError(
            f"lane-species stoichiometry {s} exceeds the lane width")
    return s


def build_pencil_operator(
    layout: PencilLayout,
    states: np.ndarray,
    props_np,
    stoichiometry: np.ndarray,
    species_cap: int,
    dtype=torch.float64,
    device="cpu",
) -> PencilOperator:
    """Assemble the pencil operator on the host (numpy), then put its
    tensors on ``device``.

    Args:
      layout: from build_pencil_layout (same state set).
      states: (n, d) the member states.
      props_np: batched propensity evaluator (m, d) -> (m, R) of numpy
        arrays or tensors (``Model.propensities``).
      stoichiometry: (R, d).
      species_cap: per-species count cap (encoder parity).
    """
    def props(st):
        out = props_np(st)
        if isinstance(out, torch.Tensor):
            out = out.cpu().numpy()
        return np.asarray(out, dtype=np.float64)

    stoich = np.asarray(stoichiometry, dtype=np.int64)
    R, d = stoich.shape
    ls = layout.lane_species
    others = [s for s in range(d) if s != ls]
    rows, nb = layout.n_rows, len(layout.bases)

    # coordinates of every cell (member or padding): the pred propensities
    # are evaluated at output cells
    cell_base = layout.row_base
    lane = np.arange(LANES, dtype=np.int64)
    cell_M = layout.row_block.astype(np.int64)[:, None] * LANES + lane[None, :]
    cell_state = np.zeros((rows, LANES, d), dtype=np.int64)
    cell_state[:, :, others] = layout.bases[cell_base][:, None, :]
    cell_state[:, :, ls] = cell_M
    member = layout.mask

    # ---- diagonal: total outflow of member cells ------------------------
    flat = cell_state.reshape(rows * LANES, d)
    props_all = props(flat).reshape(rows, LANES, R)
    diag = np.where(member, props_all.sum(axis=-1), 0.0)

    # ---- per reaction: source rows, lane shift, pred-prop field --------
    src_a, src_b = host_index_tables(layout, stoich)
    pred_prop = np.zeros((R, rows, LANES), dtype=np.float64)
    shifts = []
    pm = layout.mask.reshape(-1)
    for k in range(R):
        s = _check_shift(int(stoich[k, ls]))
        shifts.append(s)
        pred_bases = layout.bases[cell_base].astype(np.int64) - stoich[
            k, others]
        b2 = _lookup_bases(layout, pred_bases)  # (rows,)
        # pred propensity a_k(cell - nu_k), zero unless the pred cell is a
        # MEMBER (exact principal-submatrix semantics)
        pred_state = cell_state - stoich[k][None, None, :]
        legal = np.all((pred_state >= 0) & (pred_state <= species_cap),
                       axis=-1)
        pred_M = cell_M - s
        pred_blk = pred_M // LANES
        pred_lane = pred_M % LANES
        bok = (b2 >= 0)[:, None] & (pred_blk >= 0) & (
            pred_blk < layout.base_nrows[np.clip(b2, 0, nb - 1)][:, None])
        pred_row = (layout.base_row_start[np.clip(b2, 0, nb - 1)][:, None]
                    + np.clip(pred_blk, 0, None))
        pred_slot = np.clip(pred_row, 0, rows - 1) * LANES + pred_lane
        is_member = bok & pm[np.clip(pred_slot, 0, rows * LANES - 1)]
        use = legal & is_member & member
        pk = np.zeros((rows, LANES))
        if use.any():
            pk[use] = props(pred_state[use])[:, k]
        pred_prop[k] = pk

    cells = rows * LANES
    return PencilOperator(
        diag=torch.as_tensor(diag.reshape(cells), device=device).to(dtype),
        mask=torch.as_tensor(member.reshape(cells), device=device).to(
            torch.int8),
        pred_prop=torch.as_tensor(pred_prop.reshape(R, cells),
                                  device=device).to(dtype),
        src_a=torch.as_tensor(src_a, device=device),
        src_b=torch.as_tensor(src_b, device=device),
        shifts=tuple(shifts),
        n=torch.tensor(layout.n_states, dtype=torch.int32, device=device),
    )


def pencil_matvec(op: PencilOperator, x: torch.Tensor) -> torch.Tensor:
    """y = A_J @ x on the pencil layout; x flat (rows*LANES,)."""
    global CALLS
    CALLS += 1
    rows = op.src_a.shape[1]
    x2 = x.reshape(rows, LANES)
    y = -op.diag.reshape(rows, LANES) * x2
    # x padded with a zero row at index `rows`, so src == -1 gathers 0
    xp = torch.cat([x2, x2.new_zeros((1, LANES))], dim=0)
    for k, s in enumerate(op.shifts):
        pair = xp.index_select(0, op.pair_rows[k]).reshape(rows, 2 * LANES)
        y = y + op.pred_prop[k].reshape(rows, LANES) * _lane_shift(pair, s)
    y = torch.where(op.mask.reshape(rows, LANES) != 0, y, 0)
    return y.reshape(rows * LANES)


def make_pencil_operator_builder(
    model, stoichiometry, lane_species: int, species_cap: int,
    dtype=torch.float64, device="cpu", params=None,
):
    """Device builder of the pencil operator's fields.

    The host supplies only the small index tables (bases, row maps, source
    rows, member mask); the per-cell work (propensities over every cell
    and reaction, predecessor membership by the same row gather and lane
    shift as the matvec, the diagonal) runs on ``device``, ``_CELL_CHUNK``
    cells at a time, so its temporaries stay bounded whatever the support.
    ``params`` (a float64 tensor on ``device``) overrides the model's
    parameters.

    Returns build(bases, row_base, row_block, src_a, src_b, mask, n) ->
    PencilOperator: bases (nb, d-1) int32; row_base / row_block (rows,)
    int32 (row_base -1 on padding rows); src_a / src_b (R, rows) int32;
    mask (cells,) bool; n the member count.  Tensors or numpy arrays.
    """
    stoich_np = np.asarray(stoichiometry, dtype=np.int64)
    R, d = stoich_np.shape
    others = [s for s in range(d) if s != lane_species]
    shifts = tuple(_check_shift(int(stoich_np[k, lane_species]))
                   for k in range(R))
    dev = torch.device(device)
    stoich = torch.as_tensor(stoich_np, dtype=torch.int32, device=dev)

    def props(st):
        return model.propensities(st, params=params)

    def build(bases, row_base, row_block, src_a, src_b, mask, n):
        bases, row_base, row_block, src_a, src_b, mask = (
            torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                            else a, device=dev)
            for a in (bases, row_base, row_block, src_a, src_b, mask))
        rows = row_base.shape[0]
        cells = rows * LANES
        lane = torch.arange(LANES, dtype=torch.int32, device=dev)
        m2 = mask.reshape(rows, LANES)
        mp = torch.cat([m2.to(dtype), torch.zeros((1, LANES), dtype=dtype,
                                                  device=dev)])
        diag = torch.empty(cells, dtype=dtype, device=dev)
        pred_prop = torch.empty((R, cells), dtype=dtype, device=dev)
        step = max(1, _CELL_CHUNK // LANES)
        for r0 in range(0, rows, step):
            r1 = min(r0 + step, rows)
            rb = row_base[r0:r1]
            nr = r1 - r0
            cell_state = torch.zeros((nr, LANES, d), dtype=torch.int32,
                                     device=dev)
            cell_state[:, :, others] = bases[torch.clamp_min(rb, 0).long()][
                :, None, :]
            cell_state[:, :, lane_species] = (row_block[r0:r1, None] * LANES
                                              + lane[None, :])
            mc = m2[r0:r1]
            c0, c1 = r0 * LANES, r1 * LANES
            props_all = props(cell_state.reshape(nr * LANES, d)).reshape(
                nr, LANES, R)
            dg = torch.where(mc, props_all.sum(dim=-1), 0.0)
            dg = torch.where((rb < 0)[:, None], 0.0, dg)
            diag[c0:c1] = dg.reshape(-1).to(dtype)
            del props_all, dg
            for k in range(R):
                pred_state = cell_state - stoich[k][None, None, :]
                legal = torch.all((pred_state >= 0)
                                  & (pred_state <= species_cap), dim=-1)
                pk = props(pred_state.reshape(nr * LANES, d)).reshape(
                    nr, LANES, R)[:, :, k]
                # pred membership by the matvec's row gather + lane shift
                sa, sb = src_a[k, r0:r1], src_b[k, r0:r1]
                ia = torch.where(sa >= 0, sa, rows).long()
                ib = torch.where(sb >= 0, sb, rows).long()
                member_sh = _lane_shift(torch.cat([mp[ia], mp[ib]], dim=1),
                                        shifts[k])
                pk = torch.where(legal & (member_sh > 0) & mc, pk, 0.0)
                pred_prop[k, c0:c1] = pk.reshape(-1).to(dtype)
        return PencilOperator(
            diag=diag,
            mask=mask.to(torch.int8),
            pred_prop=pred_prop,
            src_a=src_a.to(torch.int32),
            src_b=src_b.to(torch.int32),
            shifts=shifts,
            n=torch.as_tensor(int(n), dtype=torch.int32, device=dev),
        )

    return build


def host_index_tables(layout: PencilLayout, stoichiometry: np.ndarray):
    """Host-side source-row tables for the device builder (one base
    searchsorted per reaction over ~n/128 rows)."""
    stoich = np.asarray(stoichiometry, dtype=np.int64)
    R, d = stoich.shape
    ls = layout.lane_species
    others = [s for s in range(d) if s != ls]
    nb = len(layout.bases)
    rows = layout.n_rows
    src_a = np.full((R, rows), -1, dtype=np.int32)
    src_b = np.full((R, rows), -1, dtype=np.int32)
    blk = layout.row_block.astype(np.int64)
    base_of_row = layout.bases[layout.row_base].astype(np.int64)
    for k in range(R):
        s = _check_shift(int(stoich[k, ls]))
        b2 = _lookup_bases(layout, base_of_row - stoich[k, others])
        blocks = (blk - 1, blk) if s >= 0 else (blk, blk + 1)
        for which, bb in enumerate(blocks):
            valid = (b2 >= 0) & (bb >= 0) & (
                bb < layout.base_nrows[np.clip(b2, 0, nb - 1)])
            r = np.where(
                valid, layout.base_row_start[np.clip(b2, 0, nb - 1)] + bb, -1,
            ).astype(np.int32)
            (src_a if which == 0 else src_b)[k] = r
    return src_a, src_b
