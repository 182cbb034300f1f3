"""The port's row-sharded halo stencil (ops/halo.py, the plain version of
the ``halo_stencil`` kernel) against the JAX package's halo matvec and its
TPU local kernels B7/B8 (interpret mode), in one process: each rank's rows
and halos are cut from the global vectors here, so no process group is
needed.  Inputs come from ``numpy.random.default_rng(seed)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovfspssa_tpu.boxspace.box import BoxSpace as JBox
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu.ops.halo import (
    halo_sharded_matvec_jit,
    make_halo_stencil_matvec as j_make_halo,
)
from krylovfspssa_tpu.parallel.sharded import make_mesh as j_make_mesh
from krylovfspssa_tpu_torch import SolverConfig, solve_cme_box
from krylovfspssa_tpu_torch.boxspace.box import BoxSpace as TBox
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.ops import stencil as tst
from krylovfspssa_tpu_torch.ops import stencil_cuda
from krylovfspssa_tpu_torch.ops.halo import (
    halo_from_global,
    halo_width,
    make_halo_stencil_matvec,
)
from krylovfspssa_tpu_torch.parallel.sharded import ShardMesh

torch.set_num_threads(2)

GOUTSIAS_X0 = [[2, 6, 0, 2, 0, 0]]


def _grown(box_cls, stoich, x0, targets, min_log2=2):
    box = box_cls.for_model(stoich, x0, min_log2)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    return box


def _inputs(vol, seed, density, dtype=np.float64):
    rng = np.random.default_rng(seed)
    mask = rng.random(vol) < density
    x = rng.random(vol).astype(dtype)
    return mask, x


def _sharded_plain(model, box, mask, x, n_ranks, dtype=torch.float64):
    """Concatenated per-rank halo_stencil (plain version) over n_ranks row
    shards, each rank's halos cut from the global masked x."""
    m, xt = torch.from_numpy(mask), torch.from_numpy(x).to(dtype)
    xm = torch.where(m, xt, 0)
    H, L = halo_width(box), box.volume // n_ranks
    before = stencil_cuda.HALO_LAUNCHES
    out = []
    for r in range(n_ranks):
        z0 = r * L
        pack = stencil_cuda.pack_halo_stencil(model, box, dtype, "cpu", z0, L)
        left, right = halo_from_global(xm, z0, L, H)
        out.append(stencil_cuda.halo_stencil(
            pack, m[z0:z0 + L], xt[z0:z0 + L], left, right))
    assert stencil_cuda.HALO_LAUNCHES == before  # no kernel on CPU tensors
    return torch.cat(out)


@pytest.mark.parametrize("n_ranks", [2, 4, 8])
def test_sharded_plain_matches_jax_halo_f64(n_ranks):
    """The geometry of tests/test_multidevice.py::
    test_halo_exchange_matvec_matches_single (seed 5, density 0.7)."""
    targets = [16, 16, 8, 4, 4, 4]
    jm, tm = jlib.goutsias_model(), tlib.goutsias_model()
    jb = _grown(JBox, jm.stoichiometry, GOUTSIAS_X0, targets)
    tb = _grown(TBox, tm.stoichiometry, GOUTSIAS_X0, targets)
    mask, x = _inputs(tb.volume, 5, 0.7)
    got = _sharded_plain(tm, tb, mask, x, n_ranks).numpy()
    mv = halo_sharded_matvec_jit(jm, jb, j_make_mesh(n_ranks), jnp.float64)
    assert mv is not None
    ref = np.asarray(mv(jnp.asarray(mask), jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13)
    one = tst.make_stencil_matvec(tm, tb, torch.float64, "cpu")(
        torch.from_numpy(mask), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, one, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("use_pallas,gen", [("always", "v6"), ("v5", "v5")])
def test_sharded_plain_f32_matches_tpu_local_kernels(use_pallas, gen):
    """float32 against the TPU kernels themselves: B7
    (make_pallas_local_matvec_v6) and B8 (_v5), interpret mode, 8 shards;
    the tolerance of tests/test_multidevice.py::
    test_halo_pallas_local_matches_single (f32 sums in another order)."""
    targets = [32, 16, 8, 4, 4, 4]
    jm, tm = jlib.goutsias_model(), tlib.goutsias_model()
    jb = _grown(JBox, jm.stoichiometry, GOUTSIAS_X0, targets)
    tb = _grown(TBox, tm.stoichiometry, GOUTSIAS_X0, targets)
    mask, x = _inputs(tb.volume, 23, 0.7, np.float32)
    mv = j_make_halo(jm, jb, j_make_mesh(8), jnp.float32,
                     use_pallas=use_pallas, pallas_interpret=True)
    assert getattr(mv, "_local_kernel", None) == gen
    ref = np.asarray(jax.jit(mv)(jnp.asarray(mask), jnp.asarray(x)))
    got = _sharded_plain(tm, tb, mask, x, 8, torch.float32).numpy()
    assert got.dtype == np.float32
    scale = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, atol=2e-6 * scale)


@pytest.mark.parametrize("n_ranks", [1, 2, 4, 8])
def test_shards_equal_box_stencil_bitwise(n_ranks):
    """The kernel contract on the CPU: the concatenated shards equal
    box_stencil's plain version on the whole vector bit for bit (same
    operands, same products, same order), every face of the box active."""
    tm = tlib.goutsias_model()
    tb = _grown(TBox, tm.stoichiometry, GOUTSIAS_X0, [16, 16, 8, 4, 4, 4])
    mask, x = _inputs(tb.volume, 3, 0.6)
    m = mask.reshape(tb.shape)
    for ax in range(len(tb.shape)):
        sl = [slice(None)] * len(tb.shape)
        for edge in (0, -1):
            sl[ax] = edge
            m[tuple(sl)] = True
    mask = m.reshape(-1)
    got = _sharded_plain(tm, tb, mask, x, n_ranks)
    pack = stencil_cuda.pack_stencil(tm, tb, torch.float64, "cpu")
    ref = stencil_cuda.box_stencil(pack, torch.from_numpy(mask),
                                   torch.from_numpy(x))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n_ranks", [4, 8])
def test_halo_wider_than_shard(n_ranks):
    """A box whose halo is wider than a shard (H=8 cells, L=4 or 2): each
    rank's halo spans several ranks, and the shards still give the
    unsharded y."""
    tm = tlib.toggle_file_model()
    tb = _grown(TBox, tm.stoichiometry, [[0, 0]], [2, 8], min_log2=1)
    assert halo_width(tb) > tb.volume // n_ranks
    mask, x = _inputs(tb.volume, 11, 0.8)
    got = _sharded_plain(tm, tb, mask, x, n_ranks).numpy()
    one = tst.make_stencil_matvec(tm, tb, torch.float64, "cpu")(
        torch.from_numpy(mask), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, one, rtol=1e-13, atol=1e-13)


def test_halo_from_global_pads_with_zeros():
    x = torch.arange(1, 9, dtype=torch.float64)
    left, right = halo_from_global(x, 2, 2, 3)
    assert left.tolist() == [0.0, 1.0, 2.0]
    assert right.tolist() == [5.0, 6.0, 7.0]
    left, right = halo_from_global(x, 6, 2, 3)
    assert left.tolist() == [4.0, 5.0, 6.0]
    assert right.tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("name,x0,targets", [
    ("goutsias", GOUTSIAS_X0, [16, 16, 8, 4, 4, 4]),
    ("repressilator", [[0, 0, 0]], [8, 16, 8]),
])
def test_row_fields_equal_slices_of_whole(name, x0, targets):
    """The per-rank fields, built from global indices, are the bits of the
    slices of the whole-box fields (diagonal, validity masks)."""
    tm = tlib.get_model(name)
    tb = _grown(TBox, tm.stoichiometry, x0, targets)
    mask = torch.from_numpy(_inputs(tb.volume, 0, 0.5)[0])
    whole_d = tst.make_diag_fn(tm, tb)(mask)
    whole_v = tst.dest_valid_masks(tb)
    pack = stencil_cuda.pack_stencil(tm, tb, torch.float64, "cpu")
    L = tb.volume // 4
    for r in range(4):
        rows = (r * L, L)
        sl = slice(r * L, (r + 1) * L)
        assert torch.equal(tst.make_diag_fn(tm, tb, rows=rows)(mask[sl]),
                           whole_d[sl])
        for a, b in zip(tst.dest_valid_masks(tb, rows=rows), whole_v):
            assert torch.equal(a, b[sl])
        hp = stencil_cuda.pack_halo_stencil(tm, tb, torch.float64, "cpu",
                                            *rows)
        assert torch.equal(hp.diag, pack.diag[sl])
        assert torch.equal(hp.meta, pack.meta)


def test_one_rank_mesh_takes_halo_path():
    """A mesh of one rank (no process group) takes the halo matvec with
    zero halos, as a one-device JAX mesh does, and solves as one device
    does."""
    tm = tlib.toggle_file_model()
    tb = _grown(TBox, tm.stoichiometry, [[0, 0]], [64, 32])
    mesh = ShardMesh("cpu")
    assert (mesh.rank, mesh.size) == (0, 1)
    mask, x = _inputs(tb.volume, 1, 0.6)
    m, xt = torch.from_numpy(mask), torch.from_numpy(x)
    mv = tst.select_stencil_matvec(tm, tb, SolverConfig(), torch.float64,
                                   "cpu", mesh=mesh)
    ref = tst.make_stencil_matvec(tm, tb, torch.float64, "cpu")(m, xt)
    np.testing.assert_allclose(mv(m, xt).numpy(), ref.numpy(), rtol=1e-13,
                               atol=1e-13)
    kw = dict(fsp_tol=1e-4, krylov_tol=1e-8)
    r1 = solve_cme_box(tm, 1.0, [[0, 0]], device="cpu", **kw)
    rm = solve_cme_box(tm, 1.0, [[0, 0]], mesh=mesh, **kw)
    assert rm.box.shape == r1.box.shape
    assert rm.stats.iflag == 0 and rm.wsum >= 1 - 1e-4
    assert np.max(np.abs(rm.w_flat - r1.w_flat)) <= 1e-9


def test_refusals_under_a_mesh():
    """Under a mesh a model that does not factor takes the direct halo
    matvec (the separable factory returns None for it, as the JAX one
    does), and use_halo=False keeps halo_stencil with gathered halos: both
    equal the one-device plain stencil.  Wrong halos are refused."""
    mesh = ShardMesh("cpu")
    cm = tlib.toggle_programmatic_model()
    cb = _grown(TBox, cm.stoichiometry, [[0, 0]], [16, 16])
    assert make_halo_stencil_matvec(cm, cb, mesh) is None
    mask, x = _inputs(cb.volume, 2, 0.6)
    m, xt = torch.from_numpy(mask), torch.from_numpy(x)
    before = stencil_cuda.DIRECT_LAUNCHES
    mv = tst.select_stencil_matvec(cm, cb, SolverConfig(), torch.float64,
                                   "cpu", mesh=mesh)
    np.testing.assert_allclose(
        mv(m, xt).numpy(),
        tst.make_stencil_matvec(cm, cb, torch.float64, "cpu")(m, xt).numpy(),
        rtol=1e-13, atol=1e-13)
    # the plain version on the CPU: no launch is counted
    assert stencil_cuda.DIRECT_LAUNCHES == before
    tm = tlib.toggle_file_model()
    tb = _grown(TBox, tm.stoichiometry, [[0, 0]], [16, 16])
    mask, x = _inputs(tb.volume, 3, 0.6)
    m, xt = torch.from_numpy(mask), torch.from_numpy(x)
    mv = tst.select_stencil_matvec(tm, tb, SolverConfig(use_halo=False),
                                   torch.float64, "cpu", mesh=mesh)
    np.testing.assert_allclose(
        mv(m, xt).numpy(),
        tst.make_stencil_matvec(tm, tb, torch.float64, "cpu")(m, xt).numpy(),
        rtol=1e-13, atol=1e-13)
    pack = stencil_cuda.pack_halo_stencil(tm, tb, torch.float64, "cpu")
    m = torch.ones(tb.volume, dtype=torch.bool)
    x = torch.ones(tb.volume, dtype=torch.float64)
    short = torch.zeros(pack.halo - 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="halo"):
        stencil_cuda.halo_stencil(pack, m, x, short, short)
    with pytest.raises(ValueError, match="rows"):
        stencil_cuda.pack_halo_stencil(tm, tb, torch.float64, "cpu",
                                       z0=tb.volume)
