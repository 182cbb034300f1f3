"""Dense matrix exponential of the small Krylov Hessenberg matrix (PyTorch
port of ``krylovfspssa_tpu/ops/expm.py``).

Replicates EXPOKIT's ``DGPADM``/``DGPADMNORM``
(``reference/src/expokit/dgpadm.f:2-339``): irreducible diagonal Padé
of degree ``ideg`` with scaling-and-squaring, plus the ``hnorm`` output
(= |t| * inf-norm of H, dgpadm.f:71-83) that feeds the reference's Krylov
cost model.

The JAX package works on the fixed (m_max+2)^2 matrix with rows/columns
>= mx masked to zero, because its shapes must be static.  PyTorch runs
eagerly, so the port computes on the leading mx x mx block itself and
embeds the result in the identity — the same numbers as the masked form,
whose padding block solves to the identity.  Everything stays float64 on
the matrix's device; the squaring count is read on the host (one sync),
because it sets the number of squarings.
"""

from __future__ import annotations

import math

import torch


def solve_plu(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B by Gaussian elimination with partial pivoting (the
    DGESV of dgpadm.f:145).  The JAX package writes its own LU because TPU
    XLA has no float64 LU; ``torch.linalg.solve`` is an LU with partial
    pivoting in float64 on every device."""
    return torch.linalg.solve(A, B)


def _pade_coefficients(ideg: int) -> list[float]:
    """c_0..c_ideg of the (ideg,ideg) diagonal Padé (dgpadm.f:89-96)."""
    c = [1.0]
    i, j = ideg + 1, 2 * ideg + 1
    for k in range(1, ideg + 1):
        c.append(c[-1] * (i - k) / (k * (j - k)))
    return c


def _squarings(hnorm: float) -> int:
    """Fortran ns = MAX(0, INT(LOG(hnorm)/LOG(2)) + 2), clamped to 1100
    (> log2 of the float64 maximum, so every finite hnorm keeps its exact
    count; a non-finite hnorm gives NaN E for the stepper's bounded NaN
    handling instead of ~2^31 squarings).  hnorm == 0 (or NaN) -> 0."""
    if not hnorm > 0:
        return 0
    ns_f = math.trunc(math.log(hnorm) / math.log(2.0)) + 2 \
        if math.isfinite(hnorm) else 1100
    return int(min(max(ns_f, 0), 1100))


def _embed(block: torch.Tensor, MH: int) -> torch.Tensor:
    E = torch.eye(MH, dtype=block.dtype, device=block.device)
    mx = block.shape[0]
    E[:mx, :mx] = block
    return E


def expm_pade(H: torch.Tensor, mx: int, t: float, ideg: int = 6):
    """exp(t * H[:mx,:mx]) embedded in the identity, plus hnorm and ns.

    Args:
      H: (MH, MH) float64 Hessenberg workspace (entries outside the
        leading mx block are ignored).
      mx: active block size.
      t: time scale (sign included).
      ideg: Padé degree (reference default 6, KrylovSolver.f90:82).

    Returns:
      (E, hnorm, ns): E (MH, MH) float64 on H's device with
      E[:mx,:mx] = exp(t H_mx) and the identity elsewhere; hnorm =
      |t| * ||H_mx||_inf as a float (the DGPADMNORM output); ns = number
      of squarings (for the NSCALE counter).
    """
    MH = H.shape[0]
    A = H[:mx, :mx].to(torch.float64)
    eye = torch.eye(mx, dtype=torch.float64, device=H.device)

    # ---- scaling (dgpadm.f:68-87): ns with ||t*H/2^ns|| < 1/2 ----------
    hnorm = abs(t) * float(torch.max(torch.sum(torch.abs(A), dim=1)))
    ns = _squarings(hnorm)
    scale = t / (2.0 ** ns)

    coef = _pade_coefficients(ideg)
    A2 = (scale * scale) * (A @ A)

    # ---- Horner on even/odd parts (dgpadm.f:102-131) ------------------
    p = coef[ideg - 1] * eye
    q = coef[ideg] * eye
    iodd = 1
    for k in range(ideg - 1, 0, -1):
        if iodd == 1:
            q = q @ A2 + coef[k - 1] * eye
        else:
            p = p @ A2 + coef[k - 1] * eye
        iodd = 1 - iodd

    # ---- (+/-)(I + 2 (q - p)^{-1} p) (dgpadm.f:133-155) ----------------
    if iodd == 1:
        q = scale * (q @ A)
    else:
        p = scale * (p @ A)
    q = q - p
    E = 2.0 * solve_plu(q, p) + eye
    if iodd == 1 and ns == 0:
        # only reachable for odd Horner parity; with ideg=6 parity is even
        E = -E

    # ---- squaring: E <- E^(2^ns) (dgpadm.f:157-166) --------------------
    for _ in range(ns):
        E = E @ E
    return _embed(E, MH), hnorm, ns


# ------------------------------------------------------------------------
# Chebyshev alternative (DGCHBV parity, selected by ideg == 0)
# ------------------------------------------------------------------------

#: (14,14) uniform rational Chebyshev approximation of exp(x) on the
#: negative real axis (Carpenter/Ruttan/Varga tables, as used by EXPOKIT's
#: DGCHBV, reference/src/expokit/dgchbv.f:55-70).
_CHEB_ALPHA0 = 0.183216998528140087e-11
_CHEB_ALPHA = (
    (+0.557503973136501826e02, -0.204295038779771857e03),
    (-0.938666838877006739e02, +0.912874896775456363e02),
    (+0.469965415550370835e02, -0.116167609985818103e02),
    (-0.961424200626061065e01, -0.264195613880262669e01),
    (+0.752722063978321642e00, +0.670367365566377770e00),
    (-0.188781253158648576e-01, -0.343696176445802414e-01),
    (+0.143086431411801849e-03, +0.287221133228814096e-03),
)
_CHEB_THETA = (
    (-0.562314417475317895e01, +0.119406921611247440e01),
    (-0.508934679728216110e01, +0.358882439228376881e01),
    (-0.399337136365302569e01, +0.600483209099604664e01),
    (-0.226978543095856346e01, +0.846173881758693369e01),
    (+0.208756929753827868e00, +0.109912615662209418e02),
    (+0.370327340957595652e01, +0.136563731924991884e02),
    (+0.889777151877331107e01, +0.166309842834712071e02),
)


def expm_chebyshev_col0(H: torch.Tensor, mx: int, t: float):
    """First column of exp(t * H[:mx,:mx]) by Chebyshev partial fractions.

    The DGCHBV analog (dgchbv.f:2-94): y <- exp(tH) e1 via 7 complex-shifted
    linear solves (complex128 here; the JAX package solves the equivalent
    real block systems because the TPU has no complex128).  The stepper
    only consumes column 0, so this returns an (MH, MH) matrix whose
    column 0 holds the result (zero below mx) and whose other entries are
    the identity's.

    Returns (E, hnorm, ns=0) matching the expm_pade interface.
    """
    MH = H.shape[0]
    A = H[:mx, :mx].to(torch.float64)
    hnorm = abs(t) * float(torch.max(torch.sum(torch.abs(A), dim=1)))
    Ac = (A * t).to(torch.complex128)
    eye = torch.eye(mx, dtype=torch.complex128, device=H.device)
    e1 = torch.zeros((mx, 1), dtype=torch.complex128, device=H.device)
    e1[0, 0] = 1.0

    # the tabulated (alpha, theta) approximate exp(-x) on [0, inf):
    #   exp(z) = alpha0 - sum_i Re[ alpha_i * (z + theta_i)^{-1} ]
    col = torch.zeros(mx, dtype=torch.float64, device=H.device)
    col[0] = _CHEB_ALPHA0
    for (ar, ai), (tr, ti) in zip(_CHEB_ALPHA, _CHEB_THETA):
        xy = torch.linalg.solve(Ac + complex(tr, ti) * eye, e1)[:, 0]
        col = col - (complex(ar, ai) * xy).real

    E = torch.eye(MH, dtype=torch.float64, device=H.device)
    E[:, 0] = 0.0
    E[:mx, 0] = col
    return E, hnorm, 0
