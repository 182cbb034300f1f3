"""Halo-exchange stencil SpMV over a mesh of ranks (PyTorch port of
``krylovfspssa_tpu/ops/halo.py``).

The row-partitioned stencil matvec communicates only across shard
boundaries: reaction offsets reach at most ``H = max_k |offset_k|`` cells
across one.  Each rank masks its boundary slices, sends them to its
neighbours (``ShardMesh.exchange_halo``) and runs the local stencil on its
own rows plus the two received H-cell halos: the hand-written kernel
``halo_stencil`` on CUDA, its plain version on the CPU
(ops/stencil_cuda.py).

Correctness contract: the same y as the one-device stencil.  Out-of-box
sources are zeroed by the shifted factor tables (validity baked in), and a
valid source never wraps the global flat range, so ranks 0 and P-1 pad
their outer halo with zeros.

The local compute is the factored destination form, so this path needs a
separable model (models/factorize.py); every bundled expression model
qualifies.  The JAX package's TPU qualifications (``vol % (P*128)``, the
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


def make_halo_stencil_matvec(model: Model, box: BoxSpace, mesh,
                             dtype=torch.float64):
    """Build matvec(mask_l, x_l) -> y_l on this rank's rows of the box (a
    ``parallel.sharded.ShardMesh``), with the halo exchanged at every call;
    None if the model does not factor per species."""
    from . import stencil_cuda

    if stencil_cuda._factored_reaction_tables(model, box) is None:
        return None
    stencil_cuda._check_dtype("halo_stencil", dtype)
    z0, rows = mesh.rows(box.volume)
    pack = stencil_cuda.pack_halo_stencil(model, box, dtype, mesh.device,
                                          z0, rows)

    def matvec(mask, x):
        left, right = mesh.exchange_halo(x, pack.halo, mask=mask)
        return stencil_cuda.halo_stencil(pack, mask, x, left, right)

    return matvec
