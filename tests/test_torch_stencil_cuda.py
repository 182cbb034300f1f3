"""The hand-written CUDA stencil kernels (box_stencil, direct_stencil) vs
their plain PyTorch versions, on the card.  Imports nothing of JAX, so it runs on a GPU host without it:

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
    # smaller than one warp
    ("toggle", [[0, 0]], [2, 4]),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("dt,rtol", [(torch.float64, 1e-12),
                                     (torch.float32, 1e-5)])
@pytest.mark.parametrize("name,x0,targets", GEOMETRIES)
def test_cuda_kernel_matches_plain(cuda_device, name, x0, targets, dt, rtol,
                                   shift):
    """select_stencil_matvec on CUDA launches the kernel exactly once per
    matvec, and agrees with the plain version to rtol x max|y|, with x and
    mask ``shift`` elements into their buffers (16-byte lines cut at other
    places).  x meets the kernel's contract supp(x) in mask."""
    model = library.get_model(name)
    box = BoxSpace.for_model(model.stoichiometry, x0, 1)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    rng = np.random.default_rng(0)
    vol = box.volume
    m = torch.zeros(vol + shift, dtype=torch.bool, device=cuda_device)
    m[shift:] = torch.as_tensor(rng.random(vol) < 0.6, device=cuda_device)
    x = torch.zeros(vol + shift, dtype=dt, device=cuda_device)
    x[shift:] = torch.as_tensor(rng.random(vol), dtype=dt,
                                device=cuda_device)
    m, x = m[shift:], x[shift:]
    x[~m] = 0
    before = stencil_cuda.LAUNCHES
    got = stencil.select_stencil_matvec(
        model, box, SolverConfig(), dt, cuda_device)(m, x)
    torch.cuda.synchronize()
    assert stencil_cuda.LAUNCHES == before + 1
    ref = stencil.make_stencil_matvec(model, box, dt, cuda_device)(m, x)
    err = float(torch.max(torch.abs(got - ref)))
    assert err <= rtol * float(torch.max(torch.abs(ref)))


def _coupled():
    """kx/(1 + 0.1*X*Y): a propensity that does not factor per species."""
    from krylovfspssa_tpu_torch.models.model import Model

    return Model(
        n_species=2, n_reactions=4, n_parameters=4,
        stoichiometry=np.array([[1, 0], [-1, 0], [0, 1], [0, -1]]),
        species_names=["X", "Y"], parameter_names=["kx", "dx", "ky", "dy"],
        propensity_expressions=["kx/(1.0 + 0.1*X*Y)", "dx*X",
                                "ky/(1.0 + 0.5*X)", "dy*Y"],
        parameters=[50.0, 1.0, 40.0, 1.0], name="coupled",
    )


DIRECT_GEOMETRIES = [
    (library.toggle_programmatic_model, [[0, 0]], [64, 64]),
    (library.ge5d_model, [[0, 0, 0, 0, 0]], [8, 8, 4, 8, 4]),
    (_coupled, [[0, 0]], [32, 64]),
]


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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt,rtol", [(torch.float64, 1e-12),
                                     (torch.float32, 1e-5)])
@pytest.mark.parametrize("mk,x0,targets", DIRECT_GEOMETRIES,
                         ids=["toggle_programmatic", "ge5d", "coupled"])
def test_cuda_direct_kernel_matches_plain(cuda_device, mk, x0, targets, dt,
                                          rtol):
    """select_stencil_matvec on CUDA takes direct_stencil for a model that
    does not factor, launches it once per matvec, and agrees with the
    plain version (and with the kernel's arithmetic over the same packed
    operands) with every face of the box active."""
    model = mk()
    box = BoxSpace.for_model(model.stoichiometry, x0)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    m, x = _face_inputs(box, dt, cuda_device)
    before = (stencil_cuda.LAUNCHES, stencil_cuda.DIRECT_LAUNCHES)
    got = stencil.select_stencil_matvec(
        model, box, SolverConfig(), dt, cuda_device)(m, x)
    torch.cuda.synchronize()
    assert (stencil_cuda.LAUNCHES, stencil_cuda.DIRECT_LAUNCHES) == (
        before[0], before[1] + 1)
    ref = stencil.make_stencil_matvec(model, box, dt, cuda_device)(m, x)
    scale = float(torch.max(torch.abs(ref)))
    assert float(torch.max(torch.abs(got - ref))) <= rtol * scale
    pack = stencil_cuda.pack_direct_stencil(model, box, dt, cuda_device)
    plain = stencil_cuda._direct_stencil_plain(pack, m, x)
    assert float(torch.max(torch.abs(got - plain))) <= rtol * scale


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dt,rtol", [(torch.float64, 1e-12),
                                     (torch.float32, 1e-5)])
def test_cuda_direct_kernel_matches_box_stencil(cuda_device, dt, rtol):
    """A separable model through both kernels gives the same y."""
    model = library.goutsias_model()
    box = BoxSpace.for_model(model.stoichiometry, [[2, 6, 0, 2, 0, 0]])
    for s, tgt in enumerate([16, 16, 8, 4, 4, 4]):
        while box.extents[s] < tgt:
            box = box.grow(s)
    m, x = _face_inputs(box, dt, cuda_device, seed=1)
    x = torch.where(m, x, 0)  # box_stencil's contract
    y_box = stencil_cuda.make_box_stencil_matvec(
        model, box, dt, cuda_device)(m, x)
    y_dir = stencil_cuda.make_direct_stencil_matvec(
        model, box, dt, cuda_device)(m, x)
    torch.cuda.synchronize()
    scale = float(torch.max(torch.abs(y_box)))
    assert float(torch.max(torch.abs(y_dir - y_box))) <= rtol * scale
