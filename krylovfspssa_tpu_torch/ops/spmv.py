"""Sparse matrix-vector product of the table backend's CME operator
(PyTorch port of ``krylovfspssa_tpu/ops/spmv.py``).

The reference matvec is a serial scatter loop
(``reference/src/fsp/KrylovSolver.f90:577-607``); here, as in the JAX
package, the gather-ELL form is one batched gather and a row reduction:

    y[i] = sum_k pred_prop[i, k] * x[max(pred_idx[i, k], 0)] - diag[i] * x[i]

and the pencil form (ops/pencil.py) row gathers and static lane shifts.
The JAX package computes both outside any Pallas kernel (XLA fuses them),
so the port keeps them as a few torch ops on the tensors' device: there is
no hand-written kernel for them, and on a CUDA tensor they run on the
card.  ``chip_smoke.py`` times them beside their bound and a CSR SpMV.

Under a row-sharded table solve (parallel/sharded.py ``sharded_matvec``)
the operator holds one rank's rows with global ``pred_idx``, ``x`` is the
gathered whole vector and ``x_rows`` this rank's rows of it.
"""

from __future__ import annotations

import torch

from .operator import CmeOperator
from ..utils.trace import spanned
from .pencil import PencilOperator, pencil_matvec

#: number of :func:`spmv` calls (a plain counter a run resets and reads to
#: show that its matvecs went through the table operator)
CALLS = 0


@spanned("spmv")
def spmv(op, x: torch.Tensor, x_rows: torch.Tensor | None = None
         ) -> torch.Tensor:
    """y = A_J @ x with A_J the projected CME generator: gather-ELL
    (``CmeOperator``) or pencil (``PencilOperator``, dispatched to
    :func:`pencil.pencil_matvec`).  ``x_rows`` is the operator's rows of x
    when ``op`` holds one rank's rows of a row-sharded operator and ``x`` is
    the whole vector (gather-ELL only)."""
    global CALLS
    CALLS += 1
    if isinstance(op, PencilOperator):
        if x_rows is not None:
            raise ValueError("the pencil operator is not row-sharded")
        return pencil_matvec(op, x)
    rows, R = op.pred_idx.shape
    safe = torch.clamp_min(op.pred_idx, 0).reshape(-1)
    gathered = x.index_select(0, safe).reshape(rows, R)
    inflow = torch.sum(op.pred_prop * gathered, dim=1)
    return inflow - op.diag * (x if x_rows is None else x_rows)


def operator_nreactions(op) -> int:
    """Reaction count R of either operator representation."""
    if isinstance(op, PencilOperator):
        return op.pred_prop.shape[0]
    return op.props.shape[1]
