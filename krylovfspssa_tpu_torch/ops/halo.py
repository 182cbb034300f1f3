"""Halo-exchange stencil SpMV over a mesh of ranks (PyTorch port of
``krylovfspssa_tpu/ops/halo.py``).

The row-partitioned stencil matvec communicates only across shard
boundaries: reaction offsets reach at most ``H = max_k |offset_k|`` cells
across one.  Each rank masks its boundary slices, sends them to its
neighbours (``ShardMesh.exchange_halo``) and runs the local stencil on its
own rows plus the two received H-cell halos: the hand-written kernel
``halo_stencil`` (separable models) or ``direct_stencil`` on a row shard
(every other model) on CUDA, their plain versions on the CPU
(ops/stencil_cuda.py).  With ``config.use_halo=False`` the same kernels
run, and the halos are cut from an all_gather of the masked vector instead
(the JAX package then partitions its XLA stencil with GSPMD, which moves
whole shards between devices).

Correctness contract: the same y as the one-device stencil.  Out-of-box
sources are zeroed by the shifted factor tables (validity baked in), and a
valid source never wraps the global flat range, so ranks 0 and P-1 pad
their outer halo with zeros.

The separable local compute is the factored destination form
(models/factorize.py), and every bundled expression model qualifies; the
direct form reads a rank's stored diagonal and destination-indexed rates,
built from global cells.  The JAX package's TPU qualifications (``vol % (P*128)``, the
lane-pattern period) are tiling and do not apply; ``vol % P == 0`` does.
Where ``H >= L`` (small early boxes over many ranks) the halo is cut from
an all_gather instead of the neighbours' edges — the same contract.
"""

from __future__ import annotations

import torch

from ..boxspace.box import BoxSpace
from ..models.model import Model


def halo_width(box: BoxSpace) -> int:
    """H = max_k |offset_k|: how far a stencil read reaches across a shard
    boundary."""
    return max((abs(int(o)) for o in box.offsets), default=0)


def halo_from_global(x: torch.Tensor, z0: int, rows: int, halo: int):
    """(left, right) halos of the rows ``[z0, z0+rows)`` cut from the full
    flat vector ``x``: x at ``[z0-H, z0)`` and ``[z0+rows, z0+rows+H)``,
    zero outside ``[0, len(x))``."""
    vol = x.shape[0]
    left = torch.zeros(halo, dtype=x.dtype, device=x.device)
    right = torch.zeros(halo, dtype=x.dtype, device=x.device)
    lo = max(z0 - halo, 0)
    left[halo - (z0 - lo):] = x[lo:z0]
    hi = min(z0 + rows + halo, vol)
    right[:hi - z0 - rows] = x[z0 + rows:hi]
    return left, right


def _halo_fn(mesh, z0: int, rows: int, halo: int, use_halo: bool):
    """halos(mask, x) -> (left, right) of this rank's rows: swapped with
    the neighbours (``ShardMesh.exchange_halo``), or with ``use_halo``
    False cut from an all_gather of the masked vector
    (:func:`halo_from_global`).  Both give the same halos; only the
    collective differs."""
    if use_halo:
        return lambda mask, x: mesh.exchange_halo(x, halo, mask=mask)
    return lambda mask, x: halo_from_global(
        mesh.gather(torch.where(mask, x, 0)), z0, rows, halo)


def make_halo_stencil_matvec(model: Model, box: BoxSpace, mesh,
                             dtype=torch.float64, use_halo: bool = True):
    """Build matvec(mask_l, x_l) -> y_l on this rank's rows of the box (a
    ``parallel.sharded.ShardMesh``) through ``halo_stencil``, with the halo
    exchanged at every call (gathered with ``use_halo=False``, see
    :func:`_halo_fn`); None if the model does not factor per species."""
    from . import stencil_cuda

    if stencil_cuda._factored_reaction_tables(model, box) is None:
        return None
    stencil_cuda._check_dtype("halo_stencil", dtype)
    z0, rows = mesh.rows(box.volume)
    pack = stencil_cuda.pack_halo_stencil(model, box, dtype, mesh.device,
                                          z0, rows)
    halos = _halo_fn(mesh, z0, rows, pack.halo, use_halo)

    def matvec(mask, x):
        left, right = halos(mask, x)
        return stencil_cuda.halo_stencil(pack, mask, x, left, right)

    return matvec


def make_direct_halo_matvec(model: Model, box: BoxSpace, mesh,
                            dtype=torch.float64, use_halo: bool = True):
    """The direct-form counterpart of :func:`make_halo_stencil_matvec`, for
    any model (the one path of models that do not factor): matvec(mask_l,
    x_l) -> y_l through ``direct_stencil`` on this rank's pack
    (``pack_direct_stencil(z0=..., rows=...)``), with the same exchange."""
    from . import stencil_cuda

    stencil_cuda._check_dtype("direct_stencil", dtype)
    z0, rows = mesh.rows(box.volume)
    pack = stencil_cuda.pack_direct_stencil(model, box, dtype, mesh.device,
                                            z0, rows)
    halos = _halo_fn(mesh, z0, rows, pack.halo, use_halo)

    def matvec(mask, x):
        left, right = halos(mask, x)
        return stencil_cuda.direct_stencil(pack, mask, x, left, right)

    return matvec
