"""The direct-form stencil on a row shard (``pack_direct_stencil`` with
``z0``/``rows``, ``direct_stencil`` with halos, ``ops/halo.py``
``make_direct_halo_matvec``) and the gathered halos of ``use_halo=False``.

In one process: each shard's pack is the bits of the same rows of the
whole box's pack, and the shards' plain matvecs, concatenated, are the
whole-box plain matvec bit for bit in float64.  On gloo ranks (parallel/
multihost.py ``spawn``): the sharded ``toggle_programmatic`` solve against
the one-rank port and the JAX mesh solve on the 8 virtual devices of
tests/conftest.py, and the toggle stepwise ``use_halo=False`` solve on 2
and 4 ranks against one rank (tests/test_multidevice.py::
test_box_full_solve_shard_invariance_stepwise).  Inputs come from
``numpy.random.default_rng(seed)``.
"""

import numpy as np
import pytest
import torch

from krylovfspssa_tpu_torch import SolverConfig, solve_cme_box
from krylovfspssa_tpu_torch.boxspace.box import BoxSpace
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.ops import halo as thalo
from krylovfspssa_tpu_torch.ops import stencil as tst
from krylovfspssa_tpu_torch.ops import stencil_cuda
from krylovfspssa_tpu_torch.parallel.multihost import spawn
from krylovfspssa_tpu_torch.parallel.sharded import ShardMesh

torch.set_num_threads(2)

SPAWN = dict(backend="gloo", timeout_s=300, threads=1)
#: the sharded direct solve (fused, the default loop)
DIRECT = dict(t=5.0, x0=[[0, 0]], fsp_tol=1e-4, krylov_tol=1e-8)
#: the use_halo=False solve: JAX test_box_full_solve_shard_invariance_stepwise
NO_HALO = dict(t=5.0, x0=[[0, 0]], fsp_tol=1e-4, krylov_tol=1e-8)


def _grown(model, x0, targets, min_log2=2):
    box = BoxSpace.for_model(model.stoichiometry, x0, min_log2)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    return box


def _cases():
    """The two models that do not factor: the custom-propensity toggle
    (H = 512 cells on a 32x16 box, wider than a shard of 8 ranks) and the
    ge5d callable."""
    tm = tlib.toggle_programmatic_model()
    gm = tlib.ge5d_model()
    return {
        "toggle_programmatic": (tm, _grown(tm, [[0, 0]], [32, 16])),
        "ge5d": (gm, _grown(gm, [[0] * 5], [4, 4, 8, 4, 4])),
    }


def _inputs(vol, seed, density=0.6):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random(vol) < density),
            torch.from_numpy(rng.random(vol)))


@pytest.mark.parametrize("chunk", [None, 64], ids=["chunk-default",
                                                   "chunk-64"])
@pytest.mark.parametrize("ranks", [2, 4, 8])
@pytest.mark.parametrize("name", ["toggle_programmatic", "ge5d"])
def test_rank_pack_is_rows_of_whole_pack(monkeypatch, name, ranks, chunk):
    """Each rank's diag and rates equal the rows [z0, z0+L) of the
    whole-box pack bit for bit, also when the field chunks cut the
    shards' windows (chunk-64)."""
    if chunk is not None:
        monkeypatch.setattr(stencil_cuda, "_FIELD_CHUNK", chunk)
    model, box = _cases()[name]
    whole = stencil_cuda.pack_direct_stencil(model, box, torch.float64,
                                             "cpu")
    assert (whole.z0, whole.rows) == (0, box.volume)
    L = box.volume // ranks
    for r in range(ranks):
        p = stencil_cuda.pack_direct_stencil(model, box, torch.float64,
                                             "cpu", r * L, L)
        assert (p.z0, p.rows, p.halo) == (r * L, L, thalo.halo_width(box))
        assert p.rates.shape == (model.n_reactions, L)
        assert torch.equal(p.diag, whole.diag[r * L:(r + 1) * L])
        assert torch.equal(p.rates, whole.rates[:, r * L:(r + 1) * L])
        assert torch.equal(p.meta, whole.meta)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("name", ["toggle_programmatic", "ge5d"])
def test_sharded_plain_equals_whole_box(name, ranks, dtype):
    """The plain direct halo matvec of every shard, halos cut from the
    global masked x, concatenated: the whole-box plain version bit for
    bit (float64 and float32), and the plain stencil of ops/stencil.py to
    1e-13 relative in float64."""
    model, box = _cases()[name]
    mask, x = _inputs(box.volume, 3)
    x = x.to(dtype)
    whole = stencil_cuda.pack_direct_stencil(model, box, dtype, "cpu")
    y = stencil_cuda.direct_stencil(whole, mask, x)
    xm = torch.where(mask, x, 0)
    L = box.volume // ranks
    parts = []
    for r in range(ranks):
        p = stencil_cuda.pack_direct_stencil(model, box, dtype, "cpu",
                                             r * L, L)
        left, right = thalo.halo_from_global(xm, r * L, L, p.halo)
        sl = slice(r * L, (r + 1) * L)
        parts.append(stencil_cuda.direct_stencil(p, mask[sl], x[sl], left,
                                                 right))
    assert torch.equal(torch.cat(parts), y)
    if dtype == torch.float64:
        ref = tst.make_stencil_matvec(model, box, dtype, "cpu")(mask, x)
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-13,
                                   atol=1e-13)


def test_direct_stencil_halo_arguments():
    """A shard's pack needs its halos; halos must be both given, of length
    H, dtype and device of x; rows outside the box are refused."""
    model, box = _cases()["toggle_programmatic"]
    L = box.volume // 2
    p = stencil_cuda.pack_direct_stencil(model, box, torch.float64, "cpu",
                                         L, L)
    mask, x = _inputs(L, 4)
    h = torch.zeros(p.halo, dtype=torch.float64)
    with pytest.raises(ValueError, match="pass their halos"):
        stencil_cuda.direct_stencil(p, mask, x)
    with pytest.raises(ValueError, match="both halos"):
        stencil_cuda.direct_stencil(p, mask, x, h)
    with pytest.raises(ValueError, match="left halo"):
        stencil_cuda.direct_stencil(p, mask, x, h[1:], h)
    with pytest.raises(ValueError, match="right halo"):
        stencil_cuda.direct_stencil(p, mask, x, h, h.float())
    with pytest.raises(ValueError, match="rows"):
        stencil_cuda.pack_direct_stencil(model, box, torch.float64, "cpu",
                                         box.volume, 1)


@pytest.mark.parametrize("use_halo", [True, False], ids=["swap", "gather"])
@pytest.mark.parametrize("name", ["toggle_programmatic", "ge5d"])
def test_one_rank_mesh_takes_direct_halo_path(name, use_halo):
    """Under a mesh of one rank a model that does not factor takes the
    direct halo matvec (zero halos either way), equal to the whole-box
    plain version bit for bit."""
    model, box = _cases()[name]
    mesh = ShardMesh("cpu")
    mask, x = _inputs(box.volume, 5)
    mv = tst.select_stencil_matvec(model, box,
                                   SolverConfig(use_halo=use_halo),
                                   torch.float64, "cpu", mesh=mesh)
    whole = stencil_cuda.pack_direct_stencil(model, box, torch.float64,
                                             "cpu")
    assert torch.equal(mv(mask, x),
                       stencil_cuda.direct_stencil(whole, mask, x))


def test_gathered_halos_equal_swapped_halos():
    """``_halo_fn`` with use_halo False cuts the same halos from the
    gathered masked vector as the swap gives (a mesh of one rank: both
    are zero beyond the box)."""
    mesh = ShardMesh("cpu")
    mask, x = _inputs(64, 6)
    for H in (3, 64, 100):
        a = thalo._halo_fn(mesh, 0, 64, H, True)(mask, x)
        b = thalo._halo_fn(mesh, 0, 64, H, False)(mask, x)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


# ---------------------------------------------------- sharded solves ----


def _records(res):
    return list(res.stats.records)


def _solve_direct(**kw):
    return solve_cme_box(tlib.toggle_programmatic_model(), DIRECT["t"],
                         DIRECT["x0"], fsp_tol=DIRECT["fsp_tol"],
                         krylov_tol=DIRECT["krylov_tol"], **kw)


def _solve_no_halo(**kw):
    return solve_cme_box(tlib.toggle_file_model(), NO_HALO["t"],
                         NO_HALO["x0"], fsp_tol=NO_HALO["fsp_tol"],
                         krylov_tol=NO_HALO["krylov_tol"], **kw)


def _rank(mesh, direct):
    """This rank's sharded solves: the direct-form toggle (fused) when
    ``direct``, and the stepwise toggle with use_halo=False."""
    out = {}
    if direct:
        res = _solve_direct(mesh=mesh)
        out["direct"] = (res, _records(res))
    res = _solve_no_halo(mesh=mesh, config=SolverConfig(fused_steps=False,
                                                        use_halo=False))
    out["no_halo"] = (res, _records(res))
    return out


@pytest.fixture(scope="module")
def ranks():
    """world size -> every rank's solves: the direct form on 2 ranks, and
    use_halo=False on 2 and 4."""
    return {n: spawn(_rank, ["cpu"] * n, (n == 2,), **SPAWN) for n in (2, 4)}


@pytest.fixture(scope="module")
def one_rank():
    return dict(
        direct=_solve_direct(device="cpu"),
        no_halo=_solve_no_halo(device="cpu",
                               config=SolverConfig(fused_steps=False)),
    )


def _l1(a, b):
    pa = {tuple(s): p for s, p in zip(a.states, a.probabilities)}
    pb = {tuple(s): p for s, p in zip(b.states, b.probabilities)}
    return sum(abs(pa.get(k, 0.0) - pb.get(k, 0.0)) for k in set(pa) | set(pb))


def test_sharded_direct_solve_matches_one_rank(ranks, one_rank):
    """Two ranks of the direct-form toggle: equal records on both ranks,
    the one-rank solve's box and step count, and its records through
    record 8.  Record 9's drop parts at round-off (the ranks' partial
    sums: 23,832 cells dropped against 23,834), so the vectors differ in
    those cells by less than the drop threshold: within 2e-8 everywhere,
    L1 <= 2 * fsp_tol (ROADMAP Queue C)."""
    outs = ranks[2]
    (r0, rec0), (r1, rec1) = outs[0]["direct"], outs[1]["direct"]
    one = one_rank["direct"]
    assert rec0 == rec1 and np.array_equal(r0.w_flat, r1.w_flat)
    assert r0.stats.iflag == 0 and r0.wsum >= 1 - DIRECT["fsp_tol"]
    assert r0.box.shape == one.box.shape
    assert r0.stats.nstep == one.stats.nstep
    ints = ("nstep", "fsp_size", "m", "advanced", "expanded", "dropped")
    same = [all(getattr(a, f) == getattr(b, f) for f in ints)
            for a, b in zip(rec0, _records(one))]
    assert all(same[:9])
    assert np.max(np.abs(r0.w_flat - one.w_flat)) <= 2e-8
    assert _l1(r0, one) <= 2 * DIRECT["fsp_tol"]


def test_sharded_direct_solve_matches_jax_mesh(ranks):
    """Against the JAX package's mesh solve of the same model on the 8
    virtual devices (GSPMD-partitioned direct stencil): L1 <= 2 *
    fsp_tol."""
    outs = ranks[2]
    from krylovfspssa_tpu.boxsolver import solve_cme_box as j_solve
    from krylovfspssa_tpu.models import library as jlib
    from krylovfspssa_tpu.parallel.sharded import make_mesh

    j = j_solve(jlib.toggle_programmatic_model(), DIRECT["t"], DIRECT["x0"],
                fsp_tol=DIRECT["fsp_tol"], krylov_tol=DIRECT["krylov_tol"],
                mesh=make_mesh(8))
    r0 = outs[0]["direct"][0]
    assert r0.box.shape == tuple(j.box.shape)
    assert _l1(r0, j) <= 2 * DIRECT["fsp_tol"]


@pytest.mark.parametrize("n", [2, 4])
def test_use_halo_false_solve_matches_one_rank(ranks, one_rank, n):
    """The stepwise toggle with use_halo=False on 2 and 4 ranks: the JAX
    contract (same box, wsum within 1e-6, w within 1e-6 everywhere) and
    equal results on every rank."""
    one = one_rank["no_halo"]
    res = [o["no_halo"] for o in ranks[n]]
    assert all(rec == res[0][1] for _, rec in res)
    r0 = res[0][0]
    assert r0.box.shape == one.box.shape
    assert r0.wsum >= 1.0 - NO_HALO["fsp_tol"]
    assert r0.wsum == pytest.approx(one.wsum, abs=1e-6)
    np.testing.assert_allclose(r0.w_flat, one.w_flat, rtol=0, atol=1e-6)
