"""Sparse matrix-vector product of the table backend's gather-form CME
operator (PyTorch port of ``krylovfspssa_tpu/ops/spmv.py``).

The reference matvec is a serial scatter loop
(``reference/src/fsp/KrylovSolver.f90:577-607``); here, as in the JAX
package, it is one batched gather and a row reduction:

    y[i] = sum_k pred_prop[i, k] * x[max(pred_idx[i, k], 0)] - diag[i] * x[i]

The JAX package computes this outside any Pallas kernel (XLA fuses it), so
the port keeps it as a few torch ops on the tensors' device: there is no
hand-written kernel for it, and on a CUDA tensor it runs on the card.
``chip_smoke.py`` times it beside its bound and a CSR SpMV.
"""

from __future__ import annotations

import torch

from .operator import CmeOperator

#: number of :func:`spmv` calls (a plain counter a run resets and reads to
#: show that its matvecs went through the table operator)
CALLS = 0


def spmv(op: CmeOperator, x: torch.Tensor) -> torch.Tensor:
    """y = A_J @ x with A_J the projected CME generator (gather-ELL)."""
    global CALLS
    CALLS += 1
    cap, R = op.pred_idx.shape
    safe = torch.clamp_min(op.pred_idx, 0).reshape(-1)
    gathered = x.index_select(0, safe).reshape(cap, R)
    inflow = torch.sum(op.pred_prop * gathered, dim=1)
    return inflow - op.diag * x


def operator_nreactions(op: CmeOperator) -> int:
    """Reaction count R of the operator."""
    return op.props.shape[1]
