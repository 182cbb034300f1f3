"""The row-sharded box solve over ``torch.distributed``: gloo ranks on the
CPU, each a spawned process, joined through a FileStore (parallel/
multihost.py ``spawn``).  Each spawn is joined within 120 s; a rank's
traceback becomes the failure.

The sharded ops (halo exchange, matvec, dilation rounds, face test, drop
ladder, one adaptive step) on 2 and 4 ranks are held against the one-rank
port; the 2-rank toggle solve against the JAX package's mesh solve and the
unsharded port (the contract of tests/test_multidevice.py::
test_halo_full_solve_agreement); checkpoints cross between JAX and port
ranks both ways; and the CLI and the dry run drive whole sharded solves.

The rank functions live at module level (spawned processes import them);
JAX is imported only inside the tests, so the ranks never load it.
"""

import numpy as np
import pytest
import torch

from krylovfspssa_tpu_torch import SolverConfig, solve_cme_box
from krylovfspssa_tpu_torch.boxspace.box import BoxSpace
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.ops import stencil as tst
from krylovfspssa_tpu_torch.ops.halo import halo_from_global, halo_width
from krylovfspssa_tpu_torch.parallel.multihost import spawn
from krylovfspssa_tpu_torch.statespace.drop import (
    drop_loss_rate,
    drop_mask_device,
)

torch.set_num_threads(2)

#: each spawn: its ranks run one thread and are joined within this
SPAWN = dict(backend="gloo", timeout_s=120, threads=1)
GOUTSIAS_X0 = [[2, 6, 0, 2, 0, 0]]
TOGGLE = dict(t=5.0, x0=[[0, 0]], fsp_tol=1e-4, krylov_tol=1e-8)
#: JAX writes its toggle snapshot every this many steps (the solve takes
#: about 20), so the file on disk is from mid-solve
CKPT_EVERY = 17


def _grown(model, x0, targets, min_log2=2):
    box = BoxSpace.for_model(model.stoichiometry, x0, min_log2)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    return box


def _op_cases():
    """(name, model, box) of the op tests: the halo-test Goutsias box
    (H = 8128 < L) and a toggle box whose halo (8 cells) is as wide as a
    2-rank shard and wider than a 4-rank one."""
    return [
        ("goutsias", tlib.goutsias_model(),
         _grown(tlib.goutsias_model(), GOUTSIAS_X0, [16, 16, 8, 4, 4, 4])),
        ("toggle-2x8", tlib.toggle_file_model(),
         _grown(tlib.toggle_file_model(), [[0, 0]], [2, 8], min_log2=1)),
    ]


def _op_inputs(box, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(box.volume) < 0.7
    x = rng.random(box.volume)
    sparse = rng.random(box.volume) < 0.02
    sparse[0] = True
    faces = []
    for s in range(box.n_species):  # one active cell on each upper face
        m = np.zeros(box.volume, bool)
        coord = np.zeros((1, box.n_species), np.int64)
        coord[0, s] = box.extents[s] - 1
        m[int(box.flat_index(coord)[0])] = True
        faces.append(m)
    w = np.where(rng.random(box.volume) < 0.5, rng.random(box.volume) * 1e-9,
                 rng.random(box.volume) * 1e-3)
    return mask, x, sparse, faces, w


def _ops_rank(mesh):
    """Every sharded op on this rank's rows; returns numpy pieces."""
    from krylovfspssa_tpu_torch.krylov.stepper import initial_carry
    from krylovfspssa_tpu_torch.parallel import multihost
    from krylovfspssa_tpu_torch.parallel.sharded import (
        sharded_box_step_fn,
        sharded_dilate_fn,
    )

    out = {"init": multihost.initialize(),
           "world": multihost.global_mesh("cpu").size}
    for name, model, box in _op_cases():
        mask, x, sparse, faces, w = _op_inputs(box, 7)
        z0, n = mesh.rows(box.volume)
        loc = lambda a: torch.from_numpy(np.ascontiguousarray(a[z0:z0 + n]))  # noqa
        m_l, x_l = loc(mask), loc(x)
        H = halo_width(box)
        left, right = mesh.exchange_halo(x_l, H, mask=m_l)
        xm = torch.from_numpy(np.where(mask, x, 0.0))
        want = halo_from_global(xm, z0, n, H)
        mask_halo = mesh.exchange_halo(m_l, H)
        r = dict(
            gather_ok=bool(np.array_equal(multihost.host_gather(x_l, mesh),
                                          x)),
            exchange_ok=bool(torch.equal(left, want[0])
                             and torch.equal(right, want[1])),
            mask_halo_ok=bool(all(torch.equal(a, b) for a, b in zip(
                mask_halo, halo_from_global(torch.from_numpy(mask), z0, n,
                                            H)))),
            y=tst.select_stencil_matvec(
                model, box, SolverConfig(), torch.float64, "cpu", mesh=mesh,
            )(m_l, x_l).numpy(),
        )
        dil = sharded_dilate_fn(mesh, box)
        d = loc(sparse)
        for _ in range(3):
            d = dil(d)
        r["dilated"] = d.numpy()
        r["faces"] = [tst.active_touches_face(box, loc(f), mesh)
                      for f in faces]
        w_l = loc(w)
        inflow = tst.make_stencil_matvec(model, box)(
            torch.from_numpy(mask), torch.from_numpy(w))[z0:z0 + n]
        dmask, count, droptol = drop_mask_device(
            w_l, inflow, m_l, 1e-7, reduce=mesh.sum)
        diag = tst.make_diag_fn(model, box, rows=(z0, n))(m_l)
        r["drop"] = (dmask.numpy(), count, droptol,
                     drop_loss_rate(w_l, inflow, diag, dmask, mesh.sum))
        out[name] = r

    # one adaptive step of the sharded box step function
    model = tlib.bursting_gene_model()
    box = _grown(model, [[0, 0]], [16, 16])
    m0, w0 = _step_start(box)
    z0, n = mesh.rows(box.volume)
    step = sharded_box_step_fn(mesh, model, box, SolverConfig())
    res = step(torch.from_numpy(m0[z0:z0 + n]),
               torch.from_numpy(w0[z0:z0 + n]),
               initial_carry(1.0, 10.0, 1e-10, 1.0, 10), 10.0, 1e-4, 1e-10)
    out["step"] = (res.w.numpy(), float(res.carry.t_now), res.wsum,
                   res.m_used)

    # a model that does not factor takes the direct halo matvec
    cm = tlib.toggle_programmatic_model()
    cb = _grown(cm, [[0, 0]], [16, 16])
    mask, x, _, _, _ = _op_inputs(cb, 11)
    z0, n = mesh.rows(cb.volume)
    out["direct"] = (tst.select_stencil_matvec(
        cm, cb, SolverConfig(), torch.float64, "cpu", mesh=mesh,
    )(torch.from_numpy(mask[z0:z0 + n]),
      torch.from_numpy(x[z0:z0 + n])).numpy(), z0, n)
    return out


def _step_start(box):
    """The start of tests/test_multidevice.py::
    test_sharded_box_step_matches_single: one cell, 5 dilation rounds."""
    mask = torch.zeros(box.volume, dtype=torch.bool)
    mask[int(box.flat_index(np.array([[0, 0]]))[0])] = True
    for _ in range(5):
        mask = tst.dilate_mask(box, mask)
    w = torch.zeros(box.volume, dtype=torch.float64)
    w[int(box.flat_index(np.array([[0, 0]]))[0])] = 1.0
    return mask.numpy(), w.numpy()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ops(request):
    n = request.param
    return n, spawn(_ops_rank, ["cpu"] * n, **SPAWN)


def _cat(outs, key, field):
    return np.concatenate([o[key][field] for o in outs])


def test_mesh_of_spawned_ranks(ops):
    n, outs = ops
    assert all(o["init"] is True and o["world"] == n for o in outs)
    assert all(o[c]["gather_ok"] for o in outs for c in ("goutsias",
                                                           "toggle-2x8"))


def test_initialize_without_a_launch(monkeypatch):
    """No torchrun variables and no address: a one-process run, nothing
    initialised.  An explicit address that cannot form a group raises."""
    import torch.distributed as dist

    from krylovfspssa_tpu_torch.parallel import multihost

    for v in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    assert multihost.initialize() is False
    assert not dist.is_initialized()
    mesh = multihost.global_mesh("cpu")
    assert (mesh.size, mesh.device.type) == (1, "cpu")
    # the default is the card: without one the mesh raises
    if torch.cuda.is_available():
        assert multihost.global_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="needs CUDA"):
            multihost.global_mesh()
    with pytest.raises((ValueError, RuntimeError)):
        multihost.initialize("tcp://127.0.0.1:29500", backend="gloo")
    assert not dist.is_initialized()


@pytest.mark.parametrize("case", ["goutsias", "toggle-2x8"])
def test_exchange_halo(ops, case):
    """Every rank's halos (x masked, and the bool mask) are the global
    cells next to its rows, zero outside the box."""
    _, outs = ops
    assert all(o[case]["exchange_ok"] and o[case]["mask_halo_ok"]
               for o in outs)


@pytest.mark.parametrize("case", ["goutsias", "toggle-2x8"])
def test_sharded_matvec(ops, case):
    _, outs = ops
    _, model, box = dict((c[0], c) for c in _op_cases())[case]
    mask, x, *_ = _op_inputs(box, 7)
    ref = tst.make_stencil_matvec(model, box)(
        torch.from_numpy(mask), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_cat(outs, case, "y"), ref, rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("case", ["goutsias", "toggle-2x8"])
def test_sharded_dilation_rounds(ops, case):
    _, outs = ops
    _, model, box = dict((c[0], c) for c in _op_cases())[case]
    _, _, sparse, _, _ = _op_inputs(box, 7)
    d = torch.from_numpy(sparse)
    for _ in range(3):
        d = tst.dilate_mask(box, d)
    assert np.array_equal(_cat(outs, case, "dilated"), d.numpy())


@pytest.mark.parametrize("case", ["goutsias", "toggle-2x8"])
def test_sharded_face_test(ops, case):
    """Every rank gets the or over all ranks of the face flags, which are
    the one-rank flags."""
    _, outs = ops
    _, model, box = dict((c[0], c) for c in _op_cases())[case]
    _, _, _, faces, _ = _op_inputs(box, 7)
    for i, f in enumerate(faces):
        want = tst.active_touches_face(box, torch.from_numpy(f))
        assert want.any()
        for o in outs:
            assert np.array_equal(o[case]["faces"][i], want)


@pytest.mark.parametrize("case", ["goutsias", "toggle-2x8"])
def test_sharded_drop_ladder(ops, case):
    _, outs = ops
    _, model, box = dict((c[0], c) for c in _op_cases())[case]
    mask, _, _, _, w = _op_inputs(box, 7)
    m, wt = torch.from_numpy(mask), torch.from_numpy(w)
    inflow = tst.make_stencil_matvec(model, box)(m, wt)
    dmask, count, droptol = drop_mask_device(wt, inflow, m, 1e-7)
    loss = drop_loss_rate(wt, inflow, tst.make_diag_fn(model, box)(m),
                          dmask)
    assert np.array_equal(
        np.concatenate([o[case]["drop"][0] for o in outs]), dmask.numpy())
    for o in outs:
        _, c, tol, lr = o[case]["drop"]
        assert (c, tol) == (count, droptol)
        assert lr == pytest.approx(loss, rel=1e-13)


def test_sharded_step_matches_single(ops):
    """One adaptive step of sharded_box_step_fn (the sharded solver's own
    step) equals the one-device solver's step
    (tests/test_multidevice.py::test_sharded_box_step_matches_single)."""
    from krylovfspssa_tpu_torch import BoxCmeSolver
    from krylovfspssa_tpu_torch.krylov.stepper import initial_carry

    _, outs = ops
    model = tlib.bursting_gene_model()
    box = _grown(model, [[0, 0]], [16, 16])
    m0, w0 = _step_start(box)
    step = BoxCmeSolver(model, SolverConfig(), device="cpu")._functions(
        box).step
    res = step(torch.from_numpy(m0), torch.from_numpy(w0),
               initial_carry(1.0, 10.0, 1e-10, 1.0, 10), 10.0, 1e-4, 1e-10)
    w = np.concatenate([o["step"][0] for o in outs])
    np.testing.assert_allclose(w, res.w.numpy(), rtol=1e-12, atol=1e-14)
    for o in outs:
        _, t_now, wsum, m_used = o["step"]
        assert t_now == pytest.approx(float(res.carry.t_now))
        assert wsum == pytest.approx(res.wsum, rel=1e-12)
        assert m_used == res.m_used


def test_nonfactoring_model_refused_under_mesh(ops):
    """A model that does not factor is no longer refused under a mesh: its
    ranks' direct halo matvecs, concatenated, are the one-device plain
    stencil to 1e-13 relative."""
    _, outs = ops
    cm = tlib.toggle_programmatic_model()
    cb = _grown(cm, [[0, 0]], [16, 16])
    mask, x, _, _, _ = _op_inputs(cb, 11)
    ref = tst.make_stencil_matvec(cm, cb)(torch.from_numpy(mask),
                                          torch.from_numpy(x)).numpy()
    y = np.concatenate([o["direct"][0] for o in outs])
    assert [o["direct"][1] for o in outs] == [r * outs[0]["direct"][2]
                                              for r in range(len(outs))]
    np.testing.assert_allclose(y, ref, rtol=1e-13, atol=1e-13)


# ------------------------------------------------- whole sharded solves --


def _records(res):
    return list(res.stats.records)


def _toggle_rank(mesh, jax_ckpt, port_ckpt):
    """The 2-rank toggle solve (writing a snapshot mid-solve), and a resume
    of the JAX package's snapshot on these ranks."""
    kw = dict(fsp_tol=TOGGLE["fsp_tol"], krylov_tol=TOGGLE["krylov_tol"],
              config=SolverConfig(fused_steps=False), mesh=mesh)
    res = solve_cme_box(tlib.toggle_file_model(), TOGGLE["t"], TOGGLE["x0"],
                        checkpoint_path=port_ckpt,
                        checkpoint_every=CKPT_EVERY, **kw)
    resumed = solve_cme_box(tlib.toggle_file_model(), 0.0,
                            resume_from=jax_ckpt, **kw)
    return res, _records(res), resumed


@pytest.fixture(scope="module")
def toggle(tmp_path_factory):
    from krylovfspssa_tpu.boxsolver import BoxCmeSolver as JSolver
    from krylovfspssa_tpu.config import SolverConfig as JConfig
    from krylovfspssa_tpu.models import library as jlib
    from krylovfspssa_tpu.parallel.sharded import make_mesh

    d = tmp_path_factory.mktemp("sharded_ckpt")
    jsolver = JSolver(jlib.toggle_file_model(), JConfig(fused_steps=False),
                      mesh=make_mesh(2))
    jres = jsolver.solve(TOGGLE["t"], TOGGLE["x0"],
                         fsp_tol=TOGGLE["fsp_tol"],
                         krylov_tol=TOGGLE["krylov_tol"],
                         checkpoint_path=str(d / "jax.npz"),
                         checkpoint_every=CKPT_EVERY)
    ranks = spawn(_toggle_rank, ["cpu", "cpu"],
                  (str(d / "jax.npz"), str(d / "port.npz")), **SPAWN)
    one = solve_cme_box(tlib.toggle_file_model(), TOGGLE["t"], TOGGLE["x0"],
                        fsp_tol=TOGGLE["fsp_tol"],
                        krylov_tol=TOGGLE["krylov_tol"],
                        config=SolverConfig(fused_steps=False), device="cpu")
    return dict(jsolver=jsolver, jax=jres, ranks=ranks, one=one, dir=d)


def _assert_agree(res, ref, fsp_tol=TOGGLE["fsp_tol"]):
    """JAX's sharded-solve contract: same box, mass within fsp_tol, the
    vectors within 1e-6 everywhere."""
    assert res.stats.iflag == 0
    assert res.box.shape == ref.box.shape
    assert res.wsum >= 1.0 - fsp_tol
    assert np.max(np.abs(res.w_flat - ref.w_flat)) <= 1e-6


def test_two_rank_toggle_matches_jax_mesh_solve(toggle):
    _assert_agree(toggle["ranks"][0][0], toggle["jax"])


def test_two_rank_toggle_matches_unsharded_port(toggle):
    _assert_agree(toggle["ranks"][0][0], toggle["one"])


def test_ranks_take_equal_steps(toggle):
    (r0, rec0, _), (r1, rec1, _) = toggle["ranks"]
    assert len(rec0) >= r0.stats.nstep > 0
    assert rec0 == rec1
    assert np.array_equal(r0.w_flat, r1.w_flat)


def test_jax_checkpoint_resumes_on_port_ranks(toggle):
    with np.load(toggle["dir"] / "jax.npz") as z:
        assert 0 < int(z["carry_nstep"]) < toggle["jax"].stats.nstep
    for _, _, resumed in toggle["ranks"]:
        assert resumed.t == TOGGLE["t"]
        _assert_agree(resumed, toggle["jax"])


def test_port_rank_checkpoint_resumes_in_jax(toggle):
    """Rank 0 wrote the gathered snapshot in the one-device format; the
    JAX mesh solver resumes it."""
    res = toggle["ranks"][0][0]
    path = toggle["dir"] / "port.npz"
    with np.load(path) as z:
        assert 0 < int(z["carry_nstep"]) < res.stats.nstep
        assert z["mask"].size == 2 ** int(z["log2"].sum())
    r = toggle["jsolver"].solve(0.0, resume_from=str(path))
    assert r.t == TOGGLE["t"]
    _assert_agree(r, toggle["jax"])


def test_cli_devices_flag(capsys):
    """kfs-torch solve --devices 2 --device cpu (gloo ranks), the analog of
    tests/test_multidevice.py::test_cli_devices_flag."""
    import json

    from krylovfspssa_tpu_torch.cli import main

    rc = main(["solve", "bursting_gene", "--t", "1", "--fsp-tol", "1e-4",
               "--devices", "2", "--device", "cpu", "--json"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["ranks"] == 2
    assert rec["wsum"] >= 1.0 - 1e-4


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_cli_multihost_mesh_on_requested_device(monkeypatch, device):
    """kfs-torch solve --multihost without torchrun's variables solves one
    rank on --device: never a CPU mesh for a solve asked for cuda (where
    CUDA is missing, the mesh refuses instead of moving to the CPU)."""
    from krylovfspssa_tpu_torch import boxsolver
    from krylovfspssa_tpu_torch.cli import main

    class Seen(Exception):
        pass

    def solve(model, t, x0, mesh=None, **kw):
        raise Seen(mesh)

    for v in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(boxsolver, "solve_cme_box", solve)
    argv = ["solve", "bursting_gene", "--t", "1", "--multihost",
            "--device", device]
    if device == "cuda" and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            main(argv)
        return
    with pytest.raises(Seen) as seen:
        main(argv)
    mesh = seen.value.args[0]
    assert (mesh.size, mesh.device.type) == (1, device)


def test_dryrun_multichip(capsys):
    from krylovfspssa_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(2, device="cpu")
    assert res.stats.t_final >= 5.0 and res.wsum >= 1.0 - 1e-4
    out = capsys.readouterr().out
    # both halves ran: the sharded table step, then the sharded box solve
    assert "dryrun_multichip ok (table backend): 2 ranks" in out
    assert "dryrun_multichip ok" in out.split("(table backend)")[1]


def test_dryrun_multichip_defaults_to_cuda():
    """The dry run's entry points run on the card unless the CPU is named:
    with fewer cards than ranks they fail instead of moving to the CPU."""
    import inspect

    from krylovfspssa_tpu_torch.parallel import dryrun

    assert inspect.signature(dryrun.dryrun_multichip).parameters[
        "device"].default == "cuda"
    n = (torch.cuda.device_count() if torch.cuda.is_available() else 0) + 1
    with pytest.raises(RuntimeError, match="cards"):
        dryrun.dryrun_multichip(n)
    with pytest.raises(RuntimeError, match="cards"):
        dryrun.main([str(n)])
