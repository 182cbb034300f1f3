"""The hand-written CUDA stencil kernel vs its plain PyTorch version, on
the card.  Imports nothing of JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_stencil_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX).  Skips without a
CUDA device."""

import numpy as np
import pytest
import torch

from krylovfspssa_tpu_torch.boxspace.box import BoxSpace
from krylovfspssa_tpu_torch.config import SolverConfig
from krylovfspssa_tpu_torch.models import library
from krylovfspssa_tpu_torch.ops import stencil, stencil_cuda

torch.set_num_threads(2)

GEOMETRIES = [
    ("toggle", [[0, 0]], [64, 32]),
    ("goutsias", [[2, 6, 0, 2, 0, 0]], [16, 16, 8, 4, 4, 4]),
    ("repressilator", [[0, 0, 0]], [8, 16, 8]),
    ("bursting_gene", [[0, 0]], [4, 64]),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt,rtol", [(torch.float64, 1e-12),
                                     (torch.float32, 1e-5)])
@pytest.mark.parametrize("name,x0,targets", GEOMETRIES)
def test_cuda_kernel_matches_plain(cuda_device, name, x0, targets, dt, rtol):
    """select_stencil_matvec on CUDA launches the kernel exactly once per
    matvec, and agrees with the plain version to rtol x max|y|."""
    model = library.get_model(name)
    box = BoxSpace.for_model(model.stoichiometry, x0)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    rng = np.random.default_rng(0)
    m = torch.as_tensor(rng.random(box.volume) < 0.6, device=cuda_device)
    x = torch.as_tensor(rng.random(box.volume), dtype=dt, device=cuda_device)
    before = stencil_cuda.LAUNCHES
    got = stencil.select_stencil_matvec(
        model, box, SolverConfig(), dt, cuda_device)(m, x)
    torch.cuda.synchronize()
    assert stencil_cuda.LAUNCHES == before + 1
    ref = stencil.make_stencil_matvec(model, box, dt, cuda_device)(m, x)
    err = float(torch.max(torch.abs(got - ref)))
    assert err <= rtol * float(torch.max(torch.abs(ref)))
