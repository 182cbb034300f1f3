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
Under a mesh every rank takes the same flag from the reduced norm.  On a
card everything of a column after its matvec (and of the avnorm) is the
hand-written chain ``csrc/arnoldi_column.cu`` (:func:`column_update`); on
one card the box backend runs each column as one replay of a CUDA graph
(krylov/graphs.py), and under a mesh the chain's launches go one at a
time, with the all_reduce of each launch's partials between them.  The
CPU runs the plain version (:func:`column_update_plain`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.stencil_cuda import _launch
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


#: calls that launched the ``csrc/arnoldi_column.cu`` chain, one per column
#: and one per avnorm (a plain counter a run resets and reads to show that
#: its columns went through the kernel; graph replays count, captures not)
LAUNCHES = 0

#: the kernels' library with the chain's entry points declared (loaded on
#: the first launch)
_LIB = None
#: one scratch per card for the chain's partials: the launches that use it
#: are ordered on one stream (a graph's replays and the eager columns
#: alike), so columns need no scratch of their own
_SCRATCH: dict = {}


def _kernels():
    global _LIB
    if _LIB is None:
        import ctypes

        from ..ops.stencil_cuda import _library

        lib = _library()
        p, i = ctypes.c_void_p, ctypes.c_int
        for dt in ("f64", "f32"):
            for name, args in (
                    ("column", [p] * 6 + [i] * 4 + [p]),
                    ("column_launch", [p] * 6 + [i, p] + [i] * 5 + [p]),
                    ("avnorm", [p] * 3 + [i, p]),
                    ("avnorm_launch", [p] * 3 + [i, p, i, i, p])):
                fn = getattr(lib, f"kfs_arnoldi_{name}_{dt}")
                fn.argtypes, fn.restype = args, i
        for name in ("kfs_arnoldi_scratch", "kfs_arnoldi_blocks"):
            getattr(lib, name).restype = i
        lib.kfs_arnoldi_blocks.argtypes = [i]
        _LIB = lib
    return _LIB


class _Chain:
    """The kernel chain on one card for a basis V, its Hessenberg H and
    status: checked once here, then one :meth:`column` or :meth:`avnorm`
    per call.  With ``reduce`` (a mesh's ``sum``; V holds this rank's rows)
    the launches go one at a time, and each launch's per-block partials
    are summed over the ranks, elementwise, before the next launch sums
    them in its fixed order (every rank's blocks are alike: the ranks hold
    equal row counts)."""

    def __init__(self, V, H, status, break_tol=None, reduce=None):
        dev = V.device
        if V.dtype not in (torch.float64, torch.float32) or V.dim() != 2 \
                or not V.is_contiguous():
            raise ValueError(f"arnoldi kernel: a contiguous 2-d float64 or "
                             f"float32 V expected, got {V.dtype} "
                             f"{tuple(V.shape)}")
        if V.shape[1] >= 1 << 31:
            raise ValueError(f"arnoldi kernel: {V.shape[1]} cells need "
                             "64-bit indices")
        if status.device != dev or status.dtype != torch.float64 \
                or status.shape != (3,) or not status.is_contiguous():
            raise ValueError(f"arnoldi kernel: a (3,) float64 status on "
                             f"{dev} expected")
        if H is not None and (H.device != dev or H.dtype != torch.float64
                              or H.dim() != 2 or H.shape[0] != H.shape[1]
                              or not H.is_contiguous()):
            raise ValueError(f"arnoldi kernel: a contiguous square float64 "
                             f"H on {dev} expected, got {H.dtype} "
                             f"{tuple(H.shape)} on {H.device}")
        if isinstance(break_tol, torch.Tensor):
            if break_tol.device != dev or break_tol.dtype != torch.float64 \
                    or break_tol.dim() != 0:
                raise ValueError(f"arnoldi kernel: break_tol as a 0-d "
                                 f"float64 on {dev}")
        elif break_tol is not None:
            break_tol = torch.full((), float(break_tol), dtype=torch.float64,
                                   device=dev)
        self.lib = _kernels()
        self.V, self.H, self.status, self.tol = V, H, status, break_tol
        self.vol = V.shape[1]
        self.dt = "f64" if V.dtype == torch.float64 else "f32"
        self.reduce = reduce
        if dev not in _SCRATCH:
            _SCRATCH[dev] = torch.empty(self.lib.kfs_arnoldi_scratch(),
                                        dtype=torch.float64, device=dev)
        self.scratch = _SCRATCH[dev]
        self.blocks = self.lib.kfs_arnoldi_blocks(self.vol)

    def _w(self, w):
        if w.device != self.V.device or w.dtype != self.V.dtype \
                or w.shape != (self.vol,) or not w.is_contiguous():
            raise ValueError(f"arnoldi kernel: w {w.dtype} {tuple(w.shape)} "
                             f"on {w.device}, V {self.V.dtype} "
                             f"(*, {self.vol}) on {self.V.device}")
        return w.data_ptr()

    def _chain(self, name, fn, n, args) -> None:
        """Launches k = 0..n-1 of ``fn(*args[0], in, n_in, out,
        *args[1], k)``, each launch's partials reduced over the ranks."""
        red, halves = None, (self.scratch[:self.blocks],
                             self.scratch[-self.blocks:])
        for k in range(n):
            out = halves[k & 1]
            _launch(name, fn, self.V.device, (
                *args[0], 0 if red is None else red.data_ptr(),
                self.blocks, out.data_ptr(), *args[1], k))
            if k < n - 1:
                red = self.reduce(out)

    def column(self, w, j: int, qiop: int) -> None:
        global LAUNCHES
        H = self.H
        if not 1 <= j < min(H.shape[0], self.V.shape[0]):
            raise ValueError(f"arnoldi kernel: column {j} of H "
                             f"{tuple(H.shape)} and V {tuple(self.V.shape)}")
        istart = _window_start(j, qiop)
        ptrs = (self._w(w), self.V.data_ptr(), H.data_ptr(),
                self.status.data_ptr(), self.tol.data_ptr())
        if self.reduce is None:
            _launch("arnoldi_column",
                    getattr(self.lib, f"kfs_arnoldi_column_{self.dt}"),
                    self.V.device, (*ptrs, self.scratch.data_ptr(),
                                    self.vol, H.shape[0], j, istart))
        else:
            self._chain("arnoldi_column",
                        getattr(self.lib,
                                f"kfs_arnoldi_column_launch_{self.dt}"),
                        j - istart + 3,
                        (ptrs, (self.vol, H.shape[0], j, istart)))
        LAUNCHES += 1

    def avnorm(self, w) -> None:
        global LAUNCHES
        ptrs = (self._w(w), self.status.data_ptr())
        if self.reduce is None:
            _launch("arnoldi_avnorm",
                    getattr(self.lib, f"kfs_arnoldi_avnorm_{self.dt}"),
                    self.V.device, (*ptrs, self.scratch.data_ptr(),
                                    self.vol))
        else:
            self._chain("arnoldi_avnorm",
                        getattr(self.lib,
                                f"kfs_arnoldi_avnorm_launch_{self.dt}"),
                        2, (ptrs, (self.vol,)))
        LAUNCHES += 1


def column_update(w, V, H, status, j: int, qiop: int, break_tol,
                  reduce=None) -> None:
    """Everything of column j (1-based) after its matvec ``w = A v_j``, in
    place, reading nothing: the IOP dots and AXPYs, the norm, and the
    masked writes of H[:, j-1], V[j] and ``status``.  After a breakdown it
    writes zeros into V[j] and leaves H as it was.  ``break_tol`` is a
    float or a 0-d float64 tensor on V's device.

    On a card it launches the chain ``csrc/arnoldi_column.cu`` on the
    current stream (``break_tol`` read from device memory; under a mesh one
    launch at a time, ``reduce`` between them); on the CPU it runs
    :func:`column_update_plain`."""
    if not V.is_cuda:
        column_update_plain(w, V, H, status, j, qiop, break_tol, reduce)
    else:
        _Chain(V, H, status, break_tol, reduce).column(w, j, qiop)


def column_update_plain(w, V, H, status, j: int, qiop: int, break_tol,
                        reduce=None) -> None:
    """:func:`column_update` in torch ops: the kernel's plain version, and
    the column of the CPU and of a mesh."""
    f = V.dtype
    live = status[BRK] == 0
    istart = _window_start(j, qiop)
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


def avnorm_update(w, V, status, reduce=None) -> None:
    """status[AVNORM] = ||w|| for w = A v_{m+1} (0 after a breakdown), by
    the kernel on a card, else by :func:`avnorm_update_plain`; reads
    nothing."""
    if not V.is_cuda:
        avnorm_update_plain(w, status, reduce)
    else:
        _Chain(V, None, status, reduce=reduce).avnorm(w)


def avnorm_update_plain(w, status, reduce=None) -> None:
    """:func:`avnorm_update` in torch ops."""
    av = torch.sqrt(dot64(w, w, reduce))
    status[AVNORM] = torch.where(status[BRK] == 0, av, 0.0)


def _window_start(j: int, qiop: int) -> int:
    """The first basis row (1-based) column j is orthogonalised against."""
    return max(1, j - qiop + 1) if qiop > 0 else 1


def arnoldi_column(matvec, V, H, status, j: int, qiop: int, break_tol,
                   reduce=None) -> None:
    """Column j (1-based) of the factorization, in place, reading nothing:
    the matvec of V[j-1], then :func:`column_update`."""
    column_update(matvec(V[j - 1]), V, H, status, j, qiop, break_tol, reduce)


def arnoldi_avnorm(matvec, V, status, m: int, reduce=None) -> None:
    """status[AVNORM] = ||A v_{m+1}|| for the 2-corrected error estimate
    (KrylovSolver.f90:261-263), 0 after a breakdown (V[m] is then zero);
    reads nothing."""
    avnorm_update(matvec(V[m]), V, status, reduce)


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
    if graphs is None and not isinstance(break_tol, torch.Tensor):
        # once per extension, not a fill per column
        break_tol = torch.full((), float(break_tol), dtype=torch.float64,
                               device=H.device)
    if graphs is not None:
        status.zero_()
    status[MB].fill_(float(m))  # an assigned number would be a host copy
    if graphs is not None:
        for j in range(jold, m + 1):
            graphs.column(V, H, j, qiop)
        graphs.avnorm(V, m)
    elif V.is_cuda:
        # the chain, with V, H and the status checked once per extension
        chain = _Chain(V, H, status, break_tol, reduce)
        for j in range(jold, m + 1):
            chain.column(matvec(V[j - 1]), j, qiop)
        chain.avnorm(matvec(V[m]))
    else:
        for j in range(jold, m + 1):
            arnoldi_column(matvec, V, H, status, j, qiop, break_tol, reduce)
        arnoldi_avnorm(matvec, V, status, m, reduce)
    brk, mb = status[BRK], status[MB]
    # the columns jold..mb, plus the avnorm matvec unless broken
    nmult = (mb + float(2 - jold) - brk).to(torch.int64)
    return ArnoldiState(V=V, H=H, breakdown=brk > 0,
                        mbrkdwn=mb.to(torch.int64),
                        avnorm=status[AVNORM].clone(), nmult=nmult)
