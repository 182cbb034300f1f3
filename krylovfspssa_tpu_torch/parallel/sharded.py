"""Row-partitioned solves over ``torch.distributed`` (PyTorch port of
``krylovfspssa_tpu/parallel/sharded.py``): the box backend's masked box and
the table backend's state rows.

The state axis — the flat cell index of the masked box — is the one
parallel axis of the Krylov-FSP math.  The JAX package partitions it over a
1-D device mesh under a single controller; this port runs SPMD, one process
per rank.  Rank r of P holds the contiguous cells ``[r*L, (r+1)*L)``,
``L = vol / P`` (the JAX ``P("s")`` layout), and every rank runs the same
host loop on replicated scalars.  The only communication is:

  * reductions over the cell axis (sum, max, any), float64 ``all_reduce``;
    the Arnoldi dots, the FSP mass and the drop ladder go through them, so
    every rank branches on the same numbers;
  * the stencil's halo, ``H = max_k |offset_k|`` cells on each side of a
    shard, sent to and received from the neighbours (ops/halo.py);
  * full gathers of the mask and the vector where the host needs the whole
    box (growth, checkpoints, the final result).

Backends: NCCL when each rank has its own card; gloo on the CPU, and for
several ranks on one card.  gloo does not take CUDA tensors for every
operation, so under gloo a CUDA tensor is staged through host memory for
each collective; NCCL and CPU tensors go straight to the backend.

The table half (``operator_shardings``, ``shard_operator``,
``sharded_matvec``, ``sharded_step_fn``) makes the JAX module's GSPMD
layout explicit: rank r holds rows ``[r*cap/P, (r+1)*cap/P)`` of the
table's vectors and of the gather-ELL operator, whose ``pred_idx`` stay
global row indices; a matvec all-gathers x (what XLA inserts for the JAX
``sharded_matvec``) and runs this rank's rows.  ``CmeSolver(mesh=...)``
(solver.py) runs whole table solves on this layout.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

#: timeout of every process group this package creates: a collective that
#: one rank never reaches (ranks that diverged) fails instead of hanging
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)


class ShardMesh:
    """A 1-D mesh of ranks over the flat cell axis: the default process
    group, this rank, the world size and this rank's device.

    Without an initialised process group it is a mesh of one rank (no
    collective runs), as a one-device JAX mesh is.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"a mesh on {self.device} needs CUDA, which "
                               "is not available here")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if dist.is_available() and dist.is_initialized():
            self.group = dist.group.WORLD
            self.rank = dist.get_rank()
            self.size = dist.get_world_size()
            self.backend = str(dist.get_backend())
        else:
            self.group, self.rank, self.size, self.backend = None, 0, 1, None
        #: stage CUDA tensors through host memory (gloo only)
        self._host = self.backend == "gloo" and self.device.type == "cuda"

    def __repr__(self):
        return (f"ShardMesh(rank={self.rank}, size={self.size}, "
                f"backend={self.backend}, device={self.device})")

    # ------------------------------------------------------------ rows --

    def rows(self, volume: int) -> tuple[int, int]:
        """(z0, L): this rank's first global cell and its number of cells
        for a box of ``volume`` cells."""
        if volume % self.size:
            raise ValueError(
                f"a box of {volume} cells does not divide over {self.size} "
                "ranks (the row-sharded solve needs vol % ranks == 0)"
            )
        n = volume // self.size
        return self.rank * n, n

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full flat tensor (a copy on the mesh's
        device)."""
        z0, n = self.rows(full.shape[0])
        return full[z0:z0 + n].to(self.device, copy=True)

    # ----------------------------------------------------- collectives --

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self._host else t

    def _all_reduce(self, t, op) -> torch.Tensor:
        buf = torch.as_tensor(t, device=self.device).to(torch.float64,
                                                         copy=True)
        if self.size == 1:
            return buf
        buf = self._stage(buf)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(self.device)

    def sum(self, t) -> torch.Tensor:
        """Float64 sum over ranks of a local partial (a tensor of any
        shape, summed elementwise)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def max(self, t) -> torch.Tensor:
        """Float64 elementwise maximum over ranks."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def any(self, t) -> torch.Tensor:
        """Elementwise logical or over ranks (a bool tensor)."""
        return self.max(torch.as_tensor(t).to(torch.float64)) > 0

    def barrier(self) -> None:
        """Return once every rank has called it (an all_reduce, which every
        backend takes on the mesh's device)."""
        float(self.sum(torch.zeros(1)))

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s tensor on every rank (each rank passes a tensor
        of the same shape and dtype; the others' values are ignored)."""
        t = torch.as_tensor(t, device=self.device).contiguous()
        if self.size == 1:
            return t
        buf = self._stage(t)
        dist.broadcast(buf, src, group=self.group)
        return buf.to(self.device)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The full flat tensor from every rank's rows, on every rank."""
        if self.size == 1:
            return t
        is_bool = t.dtype == torch.bool
        buf = self._stage(t.contiguous().view(torch.uint8) if is_bool
                          else t.contiguous())
        out = torch.empty((self.size * buf.shape[0],), dtype=buf.dtype,
                          device=buf.device)
        dist.all_gather_into_tensor(out, buf, group=self.group)
        out = out.to(self.device)
        return out.view(torch.bool) if is_bool else out

    def exchange_halo(self, x: torch.Tensor, halo: int, mask=None):
        """(left, right) halos of this rank's rows ``x`` (global cells
        ``[z0, z0+L)``): x at the global cells ``[z0-H, z0)`` and
        ``[z0+L, z0+L+H)``, zero outside ``[0, vol)``.  With ``mask`` the
        values sent are masked (``where(mask, x, 0)``).

        Where ``H <= L`` each rank sends its first and last H cells to its
        neighbours; a wider halo (small early boxes over many ranks) is cut
        from an all_gather of the whole vector.
        """
        from ..ops.halo import halo_from_global

        n = x.shape[0]
        is_bool = x.dtype == torch.bool
        if is_bool:
            x = x.view(torch.uint8)
        if halo > n:
            xm = x if mask is None else torch.where(mask, x, 0)
            left, right = halo_from_global(
                self.gather(xm), self.rank * n, n, halo)
        else:
            left = torch.zeros(halo, dtype=x.dtype, device=self.device)
            right = torch.zeros(halo, dtype=x.dtype, device=self.device)
            if self.size > 1 and halo > 0:
                left, right = self._swap_edges(x, halo, mask, left, right)
        if is_bool:
            return left.view(torch.bool), right.view(torch.bool)
        return left, right

    def _swap_edges(self, x, halo, mask, left, right):
        n = x.shape[0]
        ops, recv = [], []

        def edge(lo, hi):
            e = x[lo:hi]
            if mask is not None:
                e = torch.where(mask[lo:hi], e, 0)
            return self._stage(e.contiguous())

        if self.rank > 0:  # my first H cells are the left rank's right halo
            buf = self._stage(left)
            ops += [dist.P2POp(dist.isend, edge(0, halo), self.rank - 1),
                    dist.P2POp(dist.irecv, buf, self.rank - 1)]
            recv.append(("left", buf))
        if self.rank < self.size - 1:
            buf = self._stage(right)
            ops += [dist.P2POp(dist.isend, edge(n - halo, n), self.rank + 1),
                    dist.P2POp(dist.irecv, buf, self.rank + 1)]
            recv.append(("right", buf))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        got = {side: buf.to(self.device) for side, buf in recv}
        return got.get("left", left), got.get("right", right)


def make_mesh(device="cuda") -> ShardMesh:
    """The 1-D mesh over the ranks of the default process group on this
    rank's ``device``: its current card unless the CPU is named.  Raises
    where CUDA is not available and the CPU was not asked for.  Without an
    initialised process group it is a mesh of one rank."""
    return ShardMesh("cuda" if device is None else device)


# -------------------------------------------------------------- table ----


def table_rows(mesh: ShardMesh, capacity: int) -> tuple[int, int]:
    """(z0, L) of this rank's rows of a table of ``capacity`` rows."""
    if capacity % mesh.size:
        raise ValueError(
            f"a table capacity of {capacity} rows does not divide over "
            f"{mesh.size} ranks (the row-sharded table solve needs "
            "capacity % ranks == 0; capacities are powers of two)"
        )
    n = capacity // mesh.size
    return mesh.rank * n, n


def operator_shardings(mesh: ShardMesh, capacity: int):
    """A ``CmeOperator`` of this rank's row slices (the JAX function's
    NamedShardings, made explicit): every per-row field is split by rows,
    ``n`` is replicated (None)."""
    from ..ops.operator import CmeOperator

    z0, n = table_rows(mesh, capacity)
    row = slice(z0, z0 + n)
    return CmeOperator(diag=row, pred_idx=row, pred_prop=row, props=row,
                       succ_idx=row, succ_legal=row, n=None)


def shard_operator(op, mesh: ShardMesh):
    """This rank's rows of a whole ``CmeOperator`` (on the mesh's
    device).  The solver builds its rows directly
    (``build_operator(rows=...)``); this is for an operator built whole."""
    sh = operator_shardings(mesh, op.diag.shape[0])
    return type(op)(*(
        (t if s is None else t[s]).to(mesh.device, copy=True)
        for t, s in zip(op, sh)
    ))


def sharded_matvec(mesh: ShardMesh):
    """matvec(op_l, x_l) -> y_l: the SpMV of this rank's operator rows on
    this rank's rows of x.  x is all-gathered first (one collective per
    matvec), then ``ops/spmv.py``'s ``spmv`` runs the local rows."""
    from ..ops.spmv import spmv

    if mesh.size == 1:
        return spmv
    return lambda op, x: spmv(op, mesh.gather(x), x)


def sharded_step_fn(mesh: ShardMesh, config, basis: dict | None = None):
    """The full adaptive step (krylov/stepper.py) on this rank's rows of
    the table: the sharded SpMV and every reduction over the mesh.
    Returns step(op_l, w_l, carry, t_out, fsptol, krytol)."""
    from ..krylov.stepper import make_step_fn
    from ..ops.spmv import operator_nreactions

    mv = sharded_matvec(mesh)

    def op_info(op):
        n, dmax = float(op.n), float(mesh.max(torch.max(op.diag)))
        return int(n), operator_nreactions(op), 2.0 * dmax

    return make_step_fn(lambda op: (lambda x: mv(op, x)), config, op_info,
                        reduce=mesh.sum, basis=basis)


# ---------------------------------------------------------------- box ----


def sharded_box_step_fn(mesh: ShardMesh, model, box, config):
    """The box-backend adaptive step on this rank's rows, as the sharded
    solve runs it (``BoxCmeSolver(mesh=...)``'s own step): the halo stencil
    matvec and every cell-axis reduction over the mesh.  Returns
    step(mask_l, w_l, carry, t_out, fsptol, krytol) (krylov/stepper.py)."""
    from ..boxsolver import BoxCmeSolver

    return BoxCmeSolver(model, config, mesh=mesh)._functions(box).step


def sharded_dilate_fn(mesh: ShardMesh, box):
    """Mask dilation (1-step FSP expansion) of this rank's rows."""
    from ..ops.stencil import make_dilate_fn

    return make_dilate_fn(box, mesh.device, mesh)
