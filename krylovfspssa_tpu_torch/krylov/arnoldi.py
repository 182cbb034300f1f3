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
The loop runs on the host; the breakdown test reads one scalar per column.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> with float64 accumulation, at ~float32 cost (a 0-d float64
    tensor on the vectors' device).

    A plain f32 tree-dot over n elements carries absolute error
    ~log2(n) * eps32 * sum|a_i b_i| — for near-orthogonal Arnoldi vectors
    that noise (~1e-6) dwarfs the true coefficient, floors the Hessenberg
    entries, and blocks Krylov-dimension growth.  Blocked accumulation
    bounds the f32 rounding to one 128-wide sum and finishes the
    cross-block reduction in f64.
    """
    if a.dtype == torch.float64:
        return torch.dot(a, b)
    p = a * b
    n = p.shape[0]
    if n % 128:
        return torch.sum(p.to(torch.float64))
    return torch.sum(torch.sum(p.reshape(-1, 128), dim=1).to(torch.float64))


class ArnoldiState(NamedTuple):
    V: torch.Tensor  #: (m_max+2, vol) basis rows; V[j] = v_{j+1} (0-based)
    H: torch.Tensor  #: (m_max+2, m_max+2) float64 Hessenberg
    breakdown: bool  #: happy breakdown occurred
    mbrkdwn: int  #: 1-based column where it occurred (== m if none)
    avnorm: float  #: ||A v_{m+1}|| (valid when no breakdown)
    nmult: int  #: matvec counter increment


def arnoldi_extend(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    V: torch.Tensor,
    H: torch.Tensor,
    jold: int,
    m: int,
    qiop: int,
    break_tol: float,
) -> ArnoldiState:
    """Extend the Arnoldi factorization from column ``jold`` to ``m``.

    Args:
      matvec: y = A @ x on flat vectors.
      V: basis with rows 0..jold-1 valid (v_1..v_jold); row jold-1 is the
        current last basis vector.  Updated in place.
      H: float64 Hessenberg data for the first jold-1 columns.  Updated in
        place.
      jold, m: 1-based resume/target columns, jold <= m.
      qiop: orthogonalization window (reference QIOP=2).
      break_tol: happy-breakdown tolerance.
    """
    f = V.dtype
    nmult = 0
    brk = False
    mb = m
    j = jold
    while j <= m:
        w = matvec(V[j - 1])  # w = A v_j
        nmult += 1
        istart = max(1, j - qiop + 1) if qiop > 0 else 1
        for i in range(istart, j + 1):
            vi = V[i - 1]
            # f64-accumulated coefficient (H is float64); the AXPY stays
            # in the basis dtype
            hij = dot64(vi, w)
            w = w - hij.to(f) * vi
            H[i - 1, j - 1] = hij
        hj1j = torch.sqrt(dot64(w, w))
        if float(hj1j) <= break_tol:
            brk, mb = True, j
            break
        H[j, j - 1] = hj1j
        V[j] = w * (1.0 / hj1j).to(f)
        j += 1

    avnorm = 0.0
    if not brk:
        # extra matvec for the 2-corrected error estimate
        # (KrylovSolver.f90:261-263)
        w = matvec(V[m])  # A v_{m+1}
        avnorm = float(torch.sqrt(dot64(w, w)))
        nmult += 1
    return ArnoldiState(V=V, H=H, breakdown=brk, mbrkdwn=mb, avnorm=avnorm,
                        nmult=nmult)
