"""The stepper's kernels on the card: ``expm_pade`` (csrc/expm_pade.cu)
against its plain version, and the Arnoldi columns replayed as CUDA graphs
(krylov/graphs.py) against the same columns run eagerly, bit for bit.
Imports nothing of JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_step_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX).  Skips without a
CUDA device."""

import numpy as np
import pytest
import torch

from krylovfspssa_tpu_torch.boxspace.box import BoxSpace
from krylovfspssa_tpu_torch.config import SolverConfig
from krylovfspssa_tpu_torch.krylov.arnoldi import arnoldi_extend
from krylovfspssa_tpu_torch.models import library
from krylovfspssa_tpu_torch.ops import expm, stencil, stencil_cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _generator_input(MH, mx, scale):
    """A block that is a generator's transpose (its columns sum to -0.1
    scale, so exp(tH) stays bounded); garbage fills the rest of the
    workspace."""
    rng = np.random.default_rng(mx)
    H = rng.normal(size=(MH, MH))
    B = np.triu(rng.random((mx, mx)), -1) * scale
    np.fill_diagonal(B, 0.0)
    B[np.arange(mx), np.arange(mx)] = -B.sum(axis=0) - 0.1 * scale
    H[:mx, :mx] = B
    return H


def _hessenberg_input(MH, mx, scale, bad):
    """tests/test_torch_expm_arnoldi.py's edge input (there the plain
    version is held against the JAX package on it): a stable
    upper-Hessenberg block, garbage around it, ``bad`` at (3, 4)."""
    rng = np.random.default_rng(1000 + mx)
    H = rng.normal(size=(MH, MH))
    H[:mx, :mx] = np.triu(rng.random((mx, mx)), -1) * scale
    H[np.arange(mx), np.arange(mx)] = -scale * (1 + rng.random(mx))
    if bad is not None:
        H[3, 4] = bad
    return H


#: (block, MH, mx, t, scale, ideg, bad).  Generator blocks: shared memory,
#: hnorm 0, many squarings.  Hessenberg blocks: mx at every residue of the
#: kernel's 8-column and 16-row tiles (ideg 5, 6 and 7 in turn: odd parity
#: with ns = 0 at the small blocks), MH = 128 beyond the shared-memory
#: design (the global scratch), MH = 144 with mx = 140 (its first LU
#: panels are taller than a warp's registers hold: the panel factored in
#: memory), a negative t, hnorm 0 by t and by the block, an infinite or
#: NaN entry.
EXPM_CASES = (
    [("generator", 102, mx, t, scale, 6, None)
     for mx, t, scale in [(1, 0.5, 1.0), (12, 0.7, 1.0), (32, 2.5, 40.0),
                          (64, 1.0, 5.0), (96, 0.3, 3.0), (97, 0.3, 3.0),
                          (102, 0.2, 2.0), (20, 30.0, 300.0), (5, 0.0, 1.0)]]
    + [("hessenberg", 102, mx, 0.3, 2.0, 5 + mx % 3, None)
       for mx in (*range(1, 18), 31, 32, 33, 63, 64, 65, *range(95, 103))]
    + [("hessenberg", *case) for case in [
        (128, 126, 0.3, 2.0, 6, None), (128, 100, 0.5, 2.0, 7, None),
        (144, 140, 0.3, 2.0, 6, None), (144, 140, 0.3, 2.0, 7, None),
        (40, 9, -0.7, 2.0, 5, None), (40, 10, 0.0, 1.0, 7, None),
        (40, 10, 0.5, 0.0, 6, None), (40, 10, 0.5, 2.0, 6, np.nan),
        (40, 10, 0.5, 2.0, 5, np.inf), (40, 10, 0.5, 2.0, 6, -np.inf)]]
)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("block,MH,mx,t,scale,ideg,bad", EXPM_CASES)
def test_expm_kernel_matches_plain(cuda_device, block, MH, mx, t, scale,
                                   ideg, bad):
    """The kernel against its plain version: E to 1e-12 x max|E| where the
    plain E is finite and NaN where it is NaN, hnorm and ns equal; one
    launch.  The plain version runs on the CPU, where
    tests/test_torch_expm_arnoldi.py holds it against the JAX package (on
    the card torch.linalg.solve raises on a system that a NaN or an
    infinity made singular)."""
    H = (_generator_input(MH, mx, scale) if block == "generator"
         else _hessenberg_input(MH, mx, scale, bad))
    Ht = torch.as_tensor(H, device=cuda_device)
    before = expm.LAUNCHES
    Ek, hk, nk = expm.expm_pade(
        Ht, torch.tensor(mx, device=cuda_device),
        torch.tensor(t, dtype=torch.float64, device=cuda_device), ideg)
    assert expm.LAUNCHES == before + 1
    Ep, hp, np_ = expm.expm_pade_plain(torch.as_tensor(H), mx, t, ideg)
    torch.cuda.synchronize()
    assert int(nk) == int(np_)
    if np.isnan(float(hp)):
        assert np.isnan(float(hk))
    else:
        assert float(hk) == pytest.approx(float(hp), rel=1e-12)
    Ek, Ep = Ek.cpu().numpy(), Ep.numpy()
    nan = np.isnan(Ep)
    np.testing.assert_array_equal(np.isnan(Ek), nan)
    if not nan.all():
        scale_e = np.abs(Ep[~nan]).max()
        assert np.abs(Ek[~nan] - Ep[~nan]).max() <= 1e-12 * scale_e


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name,targets", [("toggle", [64, 32]),
                                          ("goutsias",
                                           [16, 16, 8, 4, 4, 4])])
def test_column_graphs_equal_eager(cuda_device, name, targets):
    """The extension through the column graphs (first call captures,
    second only replays) equals the eager one bit for bit; the kernel's
    launch counter counts the replays' launches."""
    from krylovfspssa_tpu_torch.krylov.graphs import ColumnGraphs

    model = library.get_model(name)
    x0 = [[0, 0]] if name == "toggle" else [[2, 6, 0, 2, 0, 0]]
    box = BoxSpace.for_model(model.stoichiometry, x0, 1)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    rng = np.random.default_rng(1)
    mask = torch.as_tensor(rng.random(box.volume) < 0.6, device=cuda_device)
    w = torch.where(mask, torch.as_tensor(rng.random(box.volume),
                                          device=cuda_device), 0.0)
    matvec = stencil.select_stencil_matvec(model, box, SolverConfig(),
                                           torch.float64, cuda_device)
    m, tol = 12, 1e-7

    def fresh(V=None, H=None):
        """A basis and Hessenberg as a step starts them (in place when
        given: a graph is keyed by their storage)."""
        if V is None:
            V = torch.empty((m + 2, box.volume), dtype=torch.float64,
                            device=cuda_device)
            H = torch.empty((m + 2, m + 2), dtype=torch.float64,
                            device=cuda_device)
        V.zero_()
        H.zero_()
        V[0] = w / torch.linalg.vector_norm(w)
        return V, H

    Ve, He = fresh()
    se = arnoldi_extend(lambda x: matvec(mask, x), Ve, He, 1, m, 2, tol)
    graphs = ColumnGraphs(matvec, mask)
    graphs.load(mask, tol)
    Vg, Hg = fresh()
    for _ in range(2):
        fresh(Vg, Hg)
        before = stencil_cuda.LAUNCHES
        sg = arnoldi_extend(None, Vg, Hg, 1, m, 2, tol, graphs=graphs)
        torch.cuda.synchronize()
        assert torch.equal(Vg, Ve) and torch.equal(Hg, He)
        for a, b in zip(sg[2:], se[2:]):
            assert torch.equal(a, b)
        # m + 1 matvecs replayed (and one warm-up column on the first call)
        assert stencil_cuda.LAUNCHES - before in (m + 1, m + 2)
    assert len(graphs) == m + 1
