"""The Arnoldi column as a CUDA graph, on one card.

A column of krylov/arnoldi.py's extension -- the matvec of V[j-1], then the
chain of ``csrc/arnoldi_column.cu`` for the IOP dots and axpys, the norm and
the masked update of V[j], H and the status tensor (q + 2 launches for a
window of q rows: 4 at the reference's qiop = 2) -- is a few launches that
the host would otherwise enqueue one by one for each of the m columns of
every attempted step.  Here each column runs as one replay of a
``torch.cuda.CUDAGraph``, captured at its first use, and so does the avnorm
matvec that ends the extension.

:class:`ColumnGraphs` holds one box geometry's graphs on one card (the box
backend's ``box_stencil`` or ``direct_stencil`` matvec).  The stepper keeps
it in the basis dict, keyed by the geometry's matvec, so a reallocated
basis drops every graph that wrote into the old one; a graph is keyed by
the basis and Hessenberg storage and its column.  Its inputs that change
from step to step live in tensors of its own, which a step loads before the
extension: the mask (a device copy) and the breakdown tolerance (a fill).
Every output is written in place (V, H, the status tensor), so no graph
leaves a tensor in the memory pool that the geometry's graphs share, and
they may replay in any order.

Before its first capture a geometry's first column runs once eagerly on
the capture stream (one stream per card, shared by every geometry), which
initialises what a capture cannot (the kernels' library, lazily loaded
kernels; every column and the avnorm matvec launch the same kernels); a
column's second run writes what its first wrote.  A capture that fails
raises: the port does not fall back to eager columns on the card.  Under a
mesh and on the table backend the same column code runs eagerly (gloo
collectives cannot be captured, and a table operator is rebuilt at every
expansion); on one card the table's eager columns launch the same chain.

The kernels' launch counters stay honest: the launches a capture records
are taken off the counters (nothing ran) and added back at every replay.
"""

from __future__ import annotations

import torch

from ..ops import stencil_cuda
from ..utils.trace import span, spanned
from . import arnoldi
from .arnoldi import arnoldi_avnorm, arnoldi_column, new_status

#: the launch counters a graph's kernels add to: (module, name)
_COUNTERS = ((stencil_cuda, "LAUNCHES"), (stencil_cuda, "DIRECT_LAUNCHES"),
             (stencil_cuda, "HALO_LAUNCHES"), (arnoldi, "LAUNCHES"))

#: the capture stream of each card
_STREAMS: dict = {}


def _counts() -> tuple:
    return tuple(getattr(mod, name) for mod, name in _COUNTERS)


def _add_counts(delta) -> None:
    for (mod, name), n in zip(_COUNTERS, delta):
        if n:
            setattr(mod, name, getattr(mod, name) + n)


class ColumnGraphs:
    """The Arnoldi-column graphs of one box geometry's ``matvec(mask, x)``
    on one card."""

    def __init__(self, matvec, mask: torch.Tensor):
        if mask.device.type != "cuda":
            raise ValueError(f"column graphs run on a card, not on "
                             f"{mask.device}")
        dev = mask.device
        self._matvec = matvec
        #: the step's mask, copied in by :meth:`load`
        self.mask = torch.zeros_like(mask)
        #: the step's breakdown tolerance
        self.tol = torch.zeros((), dtype=torch.float64, device=dev)
        #: the extension's status (arnoldi.py: BRK, MB, AVNORM)
        self.status = new_status(dev)
        self._pool = torch.cuda.graph_pool_handle()
        if dev not in _STREAMS:
            _STREAMS[dev] = torch.cuda.Stream(dev)
        self._stream = _STREAMS[dev]
        self._graphs: dict = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def load(self, mask: torch.Tensor, break_tol: float) -> None:
        """This step's mask and tolerance, for the replays that follow."""
        self.mask.copy_(mask)
        self.tol.fill_(float(break_tol))

    def _mv(self, x):
        return self._matvec(self.mask, x)

    def column(self, V, H, j: int, qiop: int) -> None:
        """Column j of the factorization (arnoldi.arnoldi_column)."""
        self._run(("column", V.data_ptr(), H.data_ptr(), j, qiop),
                  lambda: arnoldi_column(self._mv, V, H, self.status, j,
                                         qiop, self.tol))

    def avnorm(self, V, m: int) -> None:
        """The avnorm matvec after column m (arnoldi.arnoldi_avnorm)."""
        self._run(("avnorm", V.data_ptr(), m),
                  lambda: arnoldi_avnorm(self._mv, V, self.status, m))

    def _run(self, key, body) -> None:
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(body)
        graph, delta = entry
        with span("replay"):
            graph.replay()
        _add_counts(delta)

    @spanned("capture")
    def _capture(self, body):
        cur = torch.cuda.current_stream(self.mask.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            if not self._graphs:
                body()  # the warm-up: real launches, counted as such
            before = _counts()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self._pool)
            try:
                body()
            finally:
                graph.capture_end()
            delta = tuple(a - b for a, b in zip(_counts(), before))
            _add_counts(tuple(-d for d in delta))
        cur.wait_stream(self._stream)
        return graph, delta
