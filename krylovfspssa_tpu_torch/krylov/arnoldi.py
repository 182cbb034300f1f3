"""Incomplete-orthogonalization (IOP) Arnoldi process (PyTorch port of
``krylovfspssa_tpu/krylov/arnoldi.py``).

Replicates the reference's IOP loop
(``reference/src/fsp/KrylovSolver.f90:236-263``): at step j the new
Krylov vector A v_j is orthogonalized only against the last ``qiop`` basis
vectors (window 2 by default), with happy-breakdown detection at
``||v|| <= break_tol`` (KrylovSolver.f90:249-256).

The basis V is a preallocated (m_max+2, vol) tensor and H a (m_max+2)^2
float64 tensor, both on the solve's device, and both are **updated in
place** (the JAX version returns new arrays; here one basis per geometry
is reused across steps, which saves a basis-sized allocation per step).
Growing m (the reference's dimension-adaptive rejection,
KrylovSolver.f90:400-432) resumes the factorization from column jold.

The extension reads nothing back from the device.  Every column from jold
to m is enqueued, and so is the extra matvec for avnorm; the breakdown is
a flag in a small float64 status tensor on the device, with the first
broken column ``mb`` beside it.  A column after the breakdown is a no-op:
it leaves H as the JAX package's early-exit loop leaves it and writes
exact zeros into its basis row, so the matvecs that still run (at most
m - mb of them, wasted work on the device) see zeros and no inf or NaN
enters V.  ``nmult`` is the JAX count (the columns up to mb, plus the
avnorm matvec when there was no breakdown), not the matvecs launched.
Under a mesh every rank takes the same flag from the reduced norm.  On one
card each column runs as one replay of a CUDA graph (krylov/graphs.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.trace import spanned


def dot64(a: torch.Tensor, b: torch.Tensor, reduce=None) -> torch.Tensor:
    """<a, b> with float64 accumulation, at ~float32 cost (a 0-d float64
    tensor on the vectors' device).  ``reduce`` (a mesh's ``sum``) turns
    this rank's partial dot into the dot of the whole row-sharded vectors.

    A plain f32 tree-dot over n elements carries absolute error
    ~log2(n) * eps32 * sum|a_i b_i| — for near-orthogonal Arnoldi vectors
    that noise (~1e-6) dwarfs the true coefficient, floors the Hessenberg
    entries, and blocks Krylov-dimension growth.  Blocked accumulation
    bounds the f32 rounding to one 128-wide sum and finishes the
    cross-block reduction in f64.
    """
    if a.dtype == torch.float64:
        d = torch.dot(a, b)
    else:
        p = a * b
        n = p.shape[0]
        if n % 128:
            d = torch.sum(p.to(torch.float64))
        else:
            d = torch.sum(
                torch.sum(p.reshape(-1, 128), dim=1).to(torch.float64))
    return d if reduce is None else reduce(d)


class ArnoldiState(NamedTuple):
    V: torch.Tensor  #: (m_max+2, vol) basis rows; V[j] = v_{j+1} (0-based)
    H: torch.Tensor  #: (m_max+2, m_max+2) float64 Hessenberg
    breakdown: torch.Tensor  #: 0-d bool: happy breakdown occurred
    #: 0-d int64: 1-based column where it occurred (== m if none)
    mbrkdwn: torch.Tensor
    avnorm: torch.Tensor  #: 0-d float64: ||A v_{m+1}|| (0 on a breakdown)
    nmult: torch.Tensor  #: 0-d int64: matvec counter increment (JAX's)


#: entries of the float64 status tensor: breakdown flag (0 or 1), the
#: 1-based broken column mb (m if none), avnorm
BRK, MB, AVNORM = 0, 1, 2


def new_status(device) -> torch.Tensor:
    return torch.zeros(3, dtype=torch.float64, device=device)


def arnoldi_column(matvec, V, H, status, j: int, qiop: int, break_tol,
                   reduce=None) -> None:
    """Column j (1-based) of the factorization, in place, reading nothing.

    Writes H[:, j-1], V[j] and ``status``; after a breakdown it writes
    zeros into V[j] and leaves H as it was.  ``break_tol`` is a float or a
    0-d float64 tensor on V's device."""
    f = V.dtype
    live = status[BRK] == 0
    w = matvec(V[j - 1])  # w = A v_j
    istart = max(1, j - qiop + 1) if qiop > 0 else 1
    hs = []
    for i in range(istart, j + 1):
        vi = V[i - 1]
        # f64-accumulated coefficient (H is float64); the AXPY stays in
        # the basis dtype
        hij = dot64(vi, w, reduce)
        w = w - hij.to(f) * vi
        hs.append(hij)
    col = H[istart - 1:j, j - 1]
    col.copy_(torch.where(live, torch.stack(hs), col))
    hj1j = torch.sqrt(dot64(w, w, reduce))
    small = hj1j <= break_tol
    go = live & ~small
    H[j, j - 1] = torch.where(go, hj1j, H[j, j - 1])
    # the divisor is 1 wherever the column stops: no inf or NaN is made
    inv = 1.0 / torch.where(go, hj1j, 1.0)
    V[j] = torch.where(go, w * inv.to(f), 0.0)
    brk = live & small
    status[BRK] = torch.where(brk, 1.0, status[BRK])
    status[MB] = torch.where(brk, float(j), status[MB])


def arnoldi_avnorm(matvec, V, status, m: int, reduce=None) -> None:
    """status[AVNORM] = ||A v_{m+1}|| for the 2-corrected error estimate
    (KrylovSolver.f90:261-263), 0 after a breakdown (V[m] is then zero);
    reads nothing."""
    w = matvec(V[m])
    av = torch.sqrt(dot64(w, w, reduce))
    status[AVNORM] = torch.where(status[BRK] == 0, av, 0.0)


@spanned("arnoldi")
def arnoldi_extend(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    V: torch.Tensor,
    H: torch.Tensor,
    jold: int,
    m: int,
    qiop: int,
    break_tol,
    reduce=None,
    graphs=None,
) -> ArnoldiState:
    """Extend the Arnoldi factorization from column ``jold`` to ``m``; every
    column is enqueued and nothing is read back.

    Args:
      matvec: y = A @ x on flat vectors.
      V: basis with rows 0..jold-1 valid (v_1..v_jold); row jold-1 is the
        current last basis vector.  Updated in place.
      H: float64 Hessenberg data for the first jold-1 columns.  Updated in
        place.
      jold, m: 1-based resume/target columns, jold <= m.
      qiop: orthogonalization window (reference QIOP=2).
      break_tol: happy-breakdown tolerance (a float, or a 0-d float64
        tensor on the device).
      reduce: a mesh's ``sum`` when V holds this rank's rows of a
        row-sharded basis (every dot is then over the whole vectors).
      graphs: None, or the geometry's :class:`~.graphs.ColumnGraphs` on one
        card, loaded with this step's mask and tolerance: each column and
        the avnorm matvec is then one replay of a CUDA graph of the same
        code, on the graphs' own matvec and tolerance (``matvec`` and
        ``break_tol`` are not used).
    """
    status = new_status(H.device) if graphs is None else graphs.status
    if graphs is not None:
        status.zero_()
    status[MB].fill_(float(m))  # an assigned number would be a host copy
    for j in range(jold, m + 1):
        if graphs is None:
            arnoldi_column(matvec, V, H, status, j, qiop, break_tol, reduce)
        else:
            graphs.column(V, H, j, qiop)
    if graphs is None:
        arnoldi_avnorm(matvec, V, status, m, reduce)
    else:
        graphs.avnorm(V, m)
    brk, mb = status[BRK], status[MB]
    # the columns jold..mb, plus the avnorm matvec unless broken
    nmult = (mb + float(2 - jold) - brk).to(torch.int64)
    return ArnoldiState(V=V, H=H, breakdown=brk > 0,
                        mbrkdwn=mb.to(torch.int64),
                        avnorm=status[AVNORM].clone(), nmult=nmult)
