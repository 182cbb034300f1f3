"""Assembly of the table backend's sparse CME generator on the device
(PyTorch port of ``krylovfspssa_tpu/ops/operator.py``).

The reference stores the operator in *scatter* (outgoing-reaction ELL) form:
column i holds the propensities of state i and ``ADJ(k,i)`` points at the
row of x_i + nu_k, so its matvec scatters
(``reference/src/fsp/KrylovSolver.f90:577-607``, assembly in
``StateSpace.f90:200-244,301-343``).  As in the JAX package, this port
builds the *transposed index set*: for each row i the incoming edges

    y[i] = sum_k  a_k(x_i - nu_k) * x[index(x_i - nu_k)]  -  diag[i] * x[i]

so the SpMV is a batched gather and a row reduction (ops/spmv.py).  The
matrix is the principal submatrix A_J of the CME generator: off-diagonal
entries exist only when both endpoints are in the projection, and the
diagonal carries the full outflow sum_k a_k(x_i), so mass flowing out of
the projection is lost — the FSP truncation.

Assembly is one batched pass on the tensors' device (propensities for all
states, key arithmetic, searches of the sorted key view) instead of the
reference's per-state hash probes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..statespace.encoding import StateEncoder
from ..utils.trace import spanned


class CmeOperator(NamedTuple):
    """Gather-form ELL representation of the projected CME generator.

    All tensors are padded to the state-table capacity; rows >= n are zero
    (-1 for the indices, False for ``succ_legal``).
    """

    #: (cap,) float — total outflow rate of each state (diagonal)
    diag: torch.Tensor
    #: (cap, R) int32 — row index of x_i - nu_k, or -1 when the predecessor
    #: is outside the projection / illegal
    pred_idx: torch.Tensor
    #: (cap, R) float — a_k(x_i - nu_k) where pred_idx >= 0, else 0
    pred_prop: torch.Tensor
    #: (cap, R) float — a_k(x_i) (outgoing propensities)
    props: torch.Tensor
    #: (cap, R) int32 — row index of x_i + nu_k, or -1 if absent/illegal
    #: (the reference ADJ; absent-vs-illegal is told by succ_legal)
    succ_idx: torch.Tensor
    #: (cap, R) bool — successor state is componentwise >= 0 and encodable
    succ_legal: torch.Tensor
    #: 0-d int32 — number of active rows
    n: torch.Tensor


def lookup_keys(sorted_keys, sorted_to_row, queries):
    """Membership lookup: int64 keys -> int32 row indices (or -1).

    ``sorted_keys`` is padded with INT64_MAX so the search stays in range;
    one ``torch.searchsorted`` replaces the reference's Brent hash probes
    (HashTable.f90:61-236).  Multi-word keys (shape (..., W)) take a
    lexicographic binary search (:func:`_lookup_keys_wide`).
    """
    if sorted_keys.ndim == 2:
        return _lookup_keys_wide(sorted_keys, sorted_to_row, queries)
    cap = sorted_keys.shape[0]
    pos = torch.searchsorted(sorted_keys, queries)
    pos = torch.clamp(pos, 0, cap - 1)
    hit = (sorted_keys[pos] == queries) & (queries >= 0)
    return torch.where(hit, sorted_to_row[pos], -1).to(torch.int32)


def _lex_less(a, b):
    """Lexicographic a < b over the trailing word axis (word 0 major)."""
    W = a.shape[-1]
    lt = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    for w in range(W):
        lt = lt | (eq & (a[..., w] < b[..., w]))
        eq = eq & (a[..., w] == b[..., w])
    return lt


def _lookup_keys_wide(sorted_keys, sorted_to_row, queries):
    """Vectorised lexicographic binary search over (cap, W) sorted keys
    (padded rows = all INT64_MAX): ceil(log2 cap) + 1 gather rounds."""
    cap, W = sorted_keys.shape
    q = queries.reshape(-1, W)
    m = q.shape[0]
    dev = q.device
    lo = torch.zeros(m, dtype=torch.int64, device=dev)
    hi = torch.full((m,), cap, dtype=torch.int64, device=dev)
    steps = int(np.ceil(np.log2(max(cap, 2)))) + 1
    for _ in range(steps):
        mid = (lo + hi) // 2
        less = _lex_less(sorted_keys[torch.clamp_max(mid, cap - 1)], q)
        lo = torch.where(less, torch.minimum(mid + 1, hi), lo)
        hi = torch.where(less, hi, mid)
    pos = torch.clamp_max(lo, cap - 1)
    hit = torch.all(sorted_keys[pos] == q, dim=-1) & (q[:, 0] >= 0)
    out = torch.where(hit, sorted_to_row[pos], -1).to(torch.int32)
    return out.reshape(queries.shape[:-1])


@spanned("build_operator")
def build_operator(
    states: torch.Tensor,
    sorted_keys: torch.Tensor,
    sorted_to_row: torch.Tensor,
    n: int,
    propensities_fn,
    stoichiometry,
    encoder: StateEncoder,
    dtype=torch.float64,
    rows: tuple[int, int] | None = None,
) -> CmeOperator:
    """Assemble the gather-form operator for the current state set, on the
    device of ``states``: every row, or with ``rows=(z0, L)`` the rows
    ``[z0, z0+L)`` of one rank of a row-sharded solve (``pred_idx`` and
    ``succ_idx`` stay global row indices; ``n`` is the whole table's).  A
    rank evaluates the propensities of every row, so its rows are the bits
    of the same rows of the whole operator.

    Args:
      states: (cap, d) int32 state table (rows >= n are padding).
      sorted_keys / sorted_to_row: sorted membership index over the table.
      n: active row count.
      propensities_fn: batched (cap, d) -> (cap, R) float64 propensity
        evaluator that keeps its input's device (``Model.propensities``).
      stoichiometry: (R, d) reaction state-changes.
      encoder: packed-key codec.
      dtype: the operator's float dtype (the solve's vector dtype).
      rows: (z0, L), this rank's rows; all rows by default.
    """
    cap_all, d = states.shape
    dev = states.device
    stoich = torch.as_tensor(np.asarray(stoichiometry), dtype=torch.int32,
                             device=dev)
    R = stoich.shape[0]

    active = torch.arange(cap_all, device=dev) < int(n)

    # every row's propensities: a predecessor's may sit on another rank
    props_all = propensities_fn(states).to(dtype)
    props_all = torch.where(active[:, None], props_all, 0.0)
    z0, cap = (0, cap_all) if rows is None else rows
    states = states[z0:z0 + cap]
    active = active[z0:z0 + cap]
    props = props_all[z0:z0 + cap]
    diag = props.sum(dim=1)

    # successors: x + nu_k  (reference ADJ columns)
    succ = states[:, None, :] + stoich[None, :, :]
    succ_keys = encoder.encode(succ.reshape(cap * R, d))
    succ_legal = (encoder.keys_valid(succ_keys).reshape(cap, R)
                  & active[:, None])
    succ_idx = lookup_keys(sorted_keys, sorted_to_row, succ_keys)
    succ_idx = torch.where(active[:, None], succ_idx.reshape(cap, R), -1)
    del succ, succ_keys

    # predecessors: x - nu_k (incoming edges; the reference patches these
    # rows one at a time in ADD_STATE, StateSpace.f90:240-244)
    pred = states[:, None, :] - stoich[None, :, :]
    pred_keys = encoder.encode(pred.reshape(cap * R, d))
    del pred
    pred_idx = lookup_keys(sorted_keys, sorted_to_row, pred_keys)
    del pred_keys
    pred_idx = torch.where(active[:, None], pred_idx.reshape(cap, R), -1)

    # incoming propensity a_k(pred) = props[pred_row, k]: already evaluated,
    # gathered (the reference's OFFDIAG(k, pred_col))
    pred_prop = torch.gather(props_all, 0,
                             torch.clamp_min(pred_idx, 0).long())
    pred_prop = torch.where(pred_idx >= 0, pred_prop, 0.0)

    return CmeOperator(
        diag=diag,
        pred_idx=pred_idx.to(torch.int32),
        pred_prop=pred_prop,
        props=props,
        succ_idx=succ_idx.to(torch.int32),
        succ_legal=succ_legal,
        n=torch.tensor(int(n), dtype=torch.int32, device=dev),
    )


def operator_nnz(op: CmeOperator) -> int:
    """Reference nnz estimate: (R+1) * n (KrylovSolver.f90:196,537)."""
    return (op.props.shape[1] + 1) * int(op.n)
