"""The Arnoldi column kernel (csrc/arnoldi_column.cu, through
krylov/arnoldi.py ``column_update`` and ``avnorm_update``) on the card,
against the plain version (``column_update_plain``, ``avnorm_update_plain``)
on the same card and inputs; its determinism; a CUDA-graph replay against
an eager launch; the launch counter under krylov/graphs.py's captures; and
the chain launched one launch at a time with a mesh's ``reduce`` between
the launches.
Imports nothing of JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_arnoldi_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX).  Skips without a
CUDA device.

Tolerances, normwise (to the largest entry of the column of H, of V[j]):
1e-13 in float64, because the kernel and cuBLAS sum a dot's <= 2^19 terms in
different trees, each within about log2(n) eps sum|a_i b_i| <= 2e-15 ||w||
of the exact dot; 1e-5 in float32, because the plain version sums blocks
of 128 float32 products in float32 (up to 7 * 2^-24 = 4e-7 of sum|a_i b_i|)
where the kernel sums every float32 product in float64.  Everything else
(the status, the rows and entries a column does not write, zeros after a
breakdown) must agree exactly."""

import numpy as np
import pytest
import torch

from krylovfspssa_tpu_torch.krylov import arnoldi

torch.set_num_threads(2)

VOLS = (1 << 18, 300_001, 100)  # the toggle's box, ragged, below a block
RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}
MH = 9


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _istart(j, qiop):
    return max(1, j - qiop + 1) if qiop > 0 else 1


def _inputs(dev, dtype, vol, j, qiop, kind="generic", tol=1e-3, seed=0):
    """(w, V, H, status) for column j: basis rows 0..j-1 orthonormal, stale
    rows after them, a garbage H.  ``kind``: a generic w; "zero" (w = 0);
    "under" / "over" (after the window's components are taken off, w's
    norm lies just under / over tol); "after" (a generic w in a column
    after a breakdown at column 2)."""
    rng = np.random.default_rng(seed + 7 * j + vol % 97)
    Q, _ = np.linalg.qr(rng.normal(size=(vol, min(j + 1, vol))))
    V = rng.normal(size=(MH, vol))
    V[:j] = Q[:, :j].T
    w = rng.normal(size=vol)
    if kind == "zero":
        w[:] = 0.0
    elif kind in ("under", "over"):
        margin = 1e-6 if dtype == torch.float64 else 1e-2
        c = tol * (1 - margin if kind == "under" else 1 + margin)
        w = c * Q[:, j] + 0.5 * Q[:, _istart(j, qiop) - 1] + 0.25 * Q[:, j - 1]
    H = rng.normal(size=(MH, MH))
    status = [1.0, 2.0, 0.0] if kind == "after" else [0.0, MH - 2, 0.0]
    return (torch.as_tensor(w, dtype=dtype, device=dev),
            torch.as_tensor(V, dtype=dtype, device=dev),
            torch.as_tensor(H, device=dev),
            torch.tensor(status, dtype=torch.float64, device=dev))


def _clone(*ts):
    return tuple(t.clone() for t in ts)


def _kernel(w, V, H, status, j, qiop, tol):
    before = arnoldi.LAUNCHES
    arnoldi.column_update(w, V, H, status, j, qiop, tol)
    torch.cuda.synchronize()
    assert arnoldi.LAUNCHES == before + 1


def _assert_column_close(got, ref, j, qiop, dtype):
    """got, ref: (V, H, status) after column j: V[j] and the entries
    H[istart-1..j, j-1] the column writes to the tolerance, the rest
    exactly."""
    (Vk, Hk, sk), (Vp, Hp, sp) = got, ref
    assert torch.equal(sk, sp), (sk, sp)
    rows = [r for r in range(Vk.shape[0]) if r != j]
    assert torch.equal(Vk[rows], Vp[rows])
    keep = torch.ones_like(Hk, dtype=torch.bool)
    keep[_istart(j, qiop) - 1:j + 1, j - 1] = False
    assert torch.equal(Hk[keep], Hp[keep])
    for a, b in ((Vk[j], Vp[j]), (Hk[~keep], Hp[~keep])):
        a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
        scale = np.abs(b).max()
        if scale == 0:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=RTOL[dtype] * scale)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("vol", VOLS)
@pytest.mark.parametrize("qiop,j", [(2, 1), (1, 6), (2, 6), (0, 6)])
@pytest.mark.parametrize("tol_as", ["float", "tensor"])
def test_column_matches_plain(cuda_device, dtype, vol, qiop, j, tol_as):
    """A live column with a generic w: H's column and V[j] within the
    tolerance, the status and everything the column does not write
    exactly; one counted launch."""
    tol = 1e-7 if tol_as == "float" else torch.tensor(
        1e-7, dtype=torch.float64, device=cuda_device)
    w, V, H, status = _inputs(cuda_device, dtype, vol, j, qiop)
    ref = _clone(V, H, status)
    _kernel(w, V, H, status, j, qiop, tol)
    arnoldi.column_update_plain(w, *ref, j, qiop, tol)
    _assert_column_close((V, H, status), ref, j, qiop, dtype)
    assert float(status[0]) == 0.0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("vol", [1 << 18, 100])
@pytest.mark.parametrize("kind,qiop,j", [
    ("zero", 2, 1), ("zero", 2, 6), ("under", 2, 6), ("under", 0, 5),
    ("over", 2, 6), ("after", 2, 6), ("after", 0, 5)])
def test_breakdown_columns_match_plain(cuda_device, dtype, vol, kind, qiop,
                                       j):
    """A breakdown (w = 0, or a norm just under tol) sets BRK and MB = j,
    keeps the column's h and writes zeros into V[j]; a norm just over tol
    is a live column; a column after a breakdown leaves H and the status
    alone and writes zeros."""
    tol = torch.tensor(1e-3, dtype=torch.float64, device=cuda_device)
    w, V, H, status = _inputs(cuda_device, dtype, vol, j, qiop, kind, 1e-3)
    H0 = H.clone()
    ref = _clone(V, H, status)
    _kernel(w, V, H, status, j, qiop, tol)
    arnoldi.column_update_plain(w, *ref, j, qiop, tol)
    _assert_column_close((V, H, status), ref, j, qiop, dtype)
    if kind == "over":
        assert float(status[0]) == 0.0 and float(H[j, j - 1]) > 1e-3
        return
    assert not V[j].any()
    assert float(H[j, j - 1]) == float(H0[j, j - 1])
    if kind == "after":
        assert torch.equal(H, H0)
        assert status.tolist() == [1.0, 2.0, 0.0]
    else:
        assert status.tolist() == [1.0, float(j), 0.0]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("vol", VOLS)
@pytest.mark.parametrize("broken", [False, True])
def test_avnorm_matches_plain(cuda_device, dtype, vol, broken):
    """status[AVNORM] = ||w|| while live (to the tolerance), 0 after a
    breakdown; the rest of the status untouched; one counted launch."""
    w, V, _, status = _inputs(cuda_device, dtype, vol, 3, 2,
                              "after" if broken else "generic")
    sp = status.clone()
    before = arnoldi.LAUNCHES
    arnoldi.avnorm_update(w, V, status)
    arnoldi.avnorm_update_plain(w, sp)
    torch.cuda.synchronize()
    assert arnoldi.LAUNCHES == before + 1
    assert torch.equal(status[:2], sp[:2])
    if broken:
        assert float(status[2]) == 0.0 == float(sp[2])
    else:
        assert float(status[2]) == pytest.approx(float(sp[2]),
                                                 rel=RTOL[dtype])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("vol", [1 << 18, 300_001])
def test_column_is_deterministic(cuda_device, dtype, vol):
    """Two launches on the same inputs give the same bits: the cross-block
    sums are partials summed in a fixed order."""
    w, V, H, status = _inputs(cuda_device, dtype, vol, 6, 2)
    runs = []
    for _ in range(2):
        out = _clone(V, H, status)
        _kernel(w, *out, 6, 2, 1e-7)
        arnoldi.avnorm_update(out[0][6], out[0], out[2])
        torch.cuda.synchronize()
        runs.append(out)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("qiop,j", [(2, 6), (0, 4)])
def test_graph_replay_equals_eager_launch(cuda_device, dtype, qiop, j):
    """The chain captured into a CUDA graph and replayed writes what an
    eager launch writes, bit for bit, with the tolerance read from device
    memory at the replay."""
    w, V, H, status = _inputs(cuda_device, dtype, 1 << 18, j, qiop)
    tol = torch.tensor(1e-7, dtype=torch.float64, device=cuda_device)
    start = _clone(V, H, status)
    eager = _clone(*start)
    _kernel(w, *eager, j, qiop, tol)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        arnoldi.column_update(w, V, H, status, j, qiop, tol)
    for t, t0 in zip((V, H, status), start):
        t.copy_(t0)
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip((V, H, status), eager):
        assert torch.equal(a, b)
    # a tolerance above the norm, loaded after the capture: a breakdown
    for t, t0 in zip((V, H, status), start):
        t.copy_(t0)
    tol.fill_(1e30)
    g.replay()
    torch.cuda.synchronize()
    assert status.tolist() == [1.0, float(j), 0.0] and not V[j].any()


@pytest.mark.requires_cuda
def test_launches_count_replays_not_captures(cuda_device):
    """Through krylov/graphs.py: the first column's warm-up and replay
    count, its capture does not; every later replay counts one, a new
    column's capture none; the avnorm the same."""
    from krylovfspssa_tpu_torch.krylov.graphs import ColumnGraphs

    vol, m = 1 << 18, 5
    rng = np.random.default_rng(4)
    mask = torch.as_tensor(rng.random(vol) < 0.7, device=cuda_device)

    def matvec(mask, x):
        return torch.where(mask, 0.3 * x.roll(1) - x, 0.0)

    V = torch.zeros((m + 2, vol), dtype=torch.float64, device=cuda_device)
    H = torch.zeros((m + 2, m + 2), dtype=torch.float64, device=cuda_device)
    x = torch.where(mask, torch.rand(vol, dtype=torch.float64,
                                     device=cuda_device), 0.0)
    V[0] = x / torch.linalg.vector_norm(x)
    graphs = ColumnGraphs(matvec, mask)
    graphs.load(mask, 1e-7)
    counts = []
    for j in (1, 1, 2, 2):
        before = arnoldi.LAUNCHES
        graphs.column(V, H, j, 2)
        counts.append(arnoldi.LAUNCHES - before)
    before = arnoldi.LAUNCHES
    graphs.avnorm(V, 2)
    graphs.avnorm(V, 2)
    torch.cuda.synchronize()
    assert counts == [2, 1, 1, 1]
    assert arnoldi.LAUNCHES - before == 2
    assert len(graphs) == 3
    assert float(graphs.status[2]) > 0


class _Reduce:
    """A mesh's ``sum`` on one card: ``scale`` times the partial (1: one
    rank; 2: two ranks holding the same rows), counting its calls."""

    def __init__(self, scale):
        self.scale, self.calls = scale, 0

    def __call__(self, t):
        self.calls += 1
        return torch.as_tensor(t).to(torch.float64, copy=True) * self.scale


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("vol", [1 << 18, 300_001, 100])
@pytest.mark.parametrize("qiop,j", [(2, 1), (2, 6), (0, 5)])
@pytest.mark.parametrize("scale", [1, 2])
def test_mesh_chain_matches_plain(cuda_device, dtype, vol, qiop, j, scale):
    """With ``reduce`` the chain goes one launch at a time and reduces each
    launch's partials: the column and the avnorm agree with the plain
    version under the same reduce (which it calls once per dot, as the
    plain version does), and with one rank (scale 1) the column is the
    one-card chain bit for bit."""
    w, V, H, status = _inputs(cuda_device, dtype, vol, j, qiop)
    tol = torch.tensor(1e-7, dtype=torch.float64, device=cuda_device)
    one_card = _clone(V, H, status)
    ref = _clone(V, H, status)
    rk, rp = _Reduce(scale), _Reduce(scale)
    before = arnoldi.LAUNCHES
    arnoldi.column_update(w, V, H, status, j, qiop, tol, reduce=rk)
    arnoldi.avnorm_update(V[j], V, status, reduce=rk)
    torch.cuda.synchronize()
    assert arnoldi.LAUNCHES == before + 2
    arnoldi.column_update_plain(w, *ref, j, qiop, tol, reduce=rp)
    arnoldi.avnorm_update_plain(ref[0][j], ref[2], reduce=rp)
    assert rk.calls == rp.calls == j - _istart(j, qiop) + 3
    _assert_column_close((V, H, status[:2]), (*ref[:2], ref[2][:2]), j,
                         qiop, dtype)
    assert float(status[2]) == pytest.approx(float(ref[2][2]),
                                             rel=RTOL[dtype])
    if scale == 1:
        _kernel(w, *one_card, j, qiop, tol)
        arnoldi.avnorm_update(one_card[0][j], one_card[0], one_card[2])
        torch.cuda.synchronize()
        for a, b in zip((V, H, status), one_card):
            assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mesh_chain_breaks_down_as_plain(cuda_device, dtype):
    """A breakdown under a reduce: the same status and zeros as the plain
    version, and a column after it writes nothing but zeros."""
    j, qiop = 6, 2
    tol = torch.tensor(1e-3, dtype=torch.float64, device=cuda_device)
    w, V, H, status = _inputs(cuda_device, dtype, 1 << 18, j, qiop, "under",
                              1e-3)
    ref = _clone(V, H, status)
    arnoldi.column_update(w, V, H, status, j, qiop, tol, reduce=_Reduce(1))
    arnoldi.column_update_plain(w, *ref, j, qiop, tol, reduce=_Reduce(1))
    torch.cuda.synchronize()
    _assert_column_close((V, H, status), ref, j, qiop, dtype)
    assert status.tolist() == [1.0, float(j), 0.0] and not V[j].any()
    H0 = H.clone()
    arnoldi.column_update(V[j - 1].clone(), V, H, status, j, qiop, tol,
                          reduce=_Reduce(1))
    torch.cuda.synchronize()
    assert torch.equal(H, H0) and not V[j].any()
    assert status.tolist() == [1.0, float(j), 0.0]
