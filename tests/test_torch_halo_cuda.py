"""The hand-written CUDA kernel ``halo_stencil`` vs its plain PyTorch
version, shard by shard, on the card.  Imports nothing of JAX, so it runs
on a GPU host without it:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_halo_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX).  Skips without a
CUDA device."""

import numpy as np
import pytest
import torch

from krylovfspssa_tpu_torch.boxspace.box import BoxSpace
from krylovfspssa_tpu_torch.models import library
from krylovfspssa_tpu_torch.ops import stencil_cuda
from krylovfspssa_tpu_torch.ops.halo import halo_from_global, halo_width

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _face_inputs(box, dt, device, seed=0):
    """A random mask with every face of the box active, and random x."""
    rng = np.random.default_rng(seed)
    m = (rng.random(box.volume) < 0.6).reshape(box.shape)
    for ax in range(len(box.shape)):
        sl = [slice(None)] * len(box.shape)
        for edge in (0, -1):
            sl[ax] = edge
            m[tuple(sl)] = True
    mask = torch.as_tensor(m.reshape(-1), device=device)
    x = torch.as_tensor(rng.random(box.volume), dtype=dt, device=device)
    return mask, x


#: (model, x0, extents, min log2): a Goutsias box whose far sources cross
#: the shard edges; one whose shards (P = 8) are smaller than a tile of the
#: row-factor table; one whose halo is wider than its shards (P >= 4)
HALO_GEOMETRIES = {
    "goutsias": (library.goutsias_model, [[2, 6, 0, 2, 0, 0]],
                 [16, 16, 8, 4, 4, 4], 2),
    "repressilator": (library.repressilator_model, [[0, 0, 0]], [4, 4, 8],
                      2),
    "toggle-2x8": (library.toggle_file_model, [[0, 0]], [2, 8], 1),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("corner", [False, True], ids=["dense", "corner"])
@pytest.mark.parametrize("dt,rtol", [(torch.float64, 1e-12),
                                     (torch.float32, 1e-5)])
@pytest.mark.parametrize("n_ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(HALO_GEOMETRIES))
def test_cuda_halo_kernel_matches_plain(cuda_device, name, n_ranks, dt,
                                        rtol, corner):
    """Each shard's kernel launch agrees with the plain version, and the
    concatenated shards equal box_stencil on the whole vector bit for bit
    (one kernel body, one table, one order).  x meets the kernel's
    contract supp(x) in mask.  ``corner``: only the box's low corner is
    active, so whole warps of cells are inactive."""
    factory, x0, targets, min_log2 = HALO_GEOMETRIES[name]
    model = factory()
    box = BoxSpace.for_model(model.stoichiometry, x0, min_log2)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    mask, x = _face_inputs(box, dt, cuda_device)
    if corner:
        keep = torch.zeros(box.shape, dtype=torch.bool, device=cuda_device)
        keep[tuple(slice(0, max(1, n // 4)) for n in box.shape)] = True
        mask &= keep.reshape(-1)
    x = torch.where(mask, x, 0)
    H, L = halo_width(box), box.volume // n_ranks
    shards = []
    for r in range(n_ranks):
        z0 = r * L
        pack = stencil_cuda.pack_halo_stencil(model, box, dt, cuda_device,
                                              z0, L)
        left, right = halo_from_global(x, z0, L, H)
        m_l, x_l = mask[z0:z0 + L], x[z0:z0 + L]
        before = stencil_cuda.HALO_LAUNCHES
        got = stencil_cuda.halo_stencil(pack, m_l, x_l, left, right)
        torch.cuda.synchronize()
        assert stencil_cuda.HALO_LAUNCHES == before + 1
        plain = stencil_cuda._halo_stencil_plain(pack, m_l, x_l, left, right)
        scale = float(torch.max(torch.abs(plain)))
        assert float(torch.max(torch.abs(got - plain))) <= rtol * scale
        shards.append(got)
    whole = stencil_cuda.box_stencil(
        stencil_cuda.pack_stencil(model, box, dt, cuda_device), mask, x)
    assert torch.equal(torch.cat(shards), whole)
