"""PyTorch port vs JAX package, end to end: box solves on the CPU in both
packages (the JAX one with its host-driven stepwise loop), held to the FSP
tolerance contract — each answer lies within fsp_tol of the truth, so the
two lie within 2*fsp_tol of each other in L1.  Step counts are reported,
not asserted: ulp-level differences can fork equally valid step
sequences.  Also: a float32 solve within the f32 contract, and
checkpoints crossing between the packages in both directions."""

import numpy as np
import pytest
import torch

from krylovfspssa_tpu.boxsolver import BoxCmeSolver as JSolver
from krylovfspssa_tpu.config import SolverConfig as JConfig
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu_torch import BoxCmeSolver, SolverConfig, solve_cme_box
from krylovfspssa_tpu_torch.models import library as tlib

torch.set_num_threads(2)

TOGGLE = dict(name="toggle", t=5.0, x0=[[0, 0]], fsp_tol=1e-4,
              krylov_tol=1e-8)
GOUTSIAS = dict(name="goutsias", t=1.0, x0=[[2, 6, 0, 2, 0, 0]],
                fsp_tol=1e-6, krylov_tol=1e-8)
#: JAX writes its toggle snapshot every this many steps; the snapshot
#: left on disk is from mid-solve (the JAX toggle run takes 20 steps)
CKPT_EVERY = 17


def _jax_run(case, tmp_path=None):
    solver = JSolver(jlib.get_model(case["name"]), JConfig(fused_steps=False))
    kw = {}
    if tmp_path is not None:
        kw = dict(checkpoint_path=str(tmp_path / "jax.npz"),
                  checkpoint_every=CKPT_EVERY)
    res = solver.solve(case["t"], case["x0"], fsp_tol=case["fsp_tol"],
                       krylov_tol=case["krylov_tol"], **kw)
    return solver, res


def _port_run(case, **kw):
    """The port's solve in the JAX side's loop (stepwise)."""
    return solve_cme_box(tlib.get_model(case["name"]), case["t"], case["x0"],
                         fsp_tol=case["fsp_tol"],
                         krylov_tol=case["krylov_tol"],
                         config=SolverConfig(fused_steps=False), device="cpu",
                         **kw)


def _l1(a, b):
    pa = {tuple(s): p for s, p in zip(a.states, a.probabilities)}
    pb = {tuple(s): p for s, p in zip(b.states, b.probabilities)}
    return sum(abs(pa.get(k, 0.0) - pb.get(k, 0.0)) for k in set(pa) | set(pb))


def _report(tag, j, t):
    print(f"{tag}: jax nstep {j.stats.nstep} nmult {j.stats.nmult} "
          f"fsp {j.stats.final_fsp_size} | port nstep {t.stats.nstep} "
          f"nmult {t.stats.nmult} fsp {t.stats.final_fsp_size}")


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpt")


@pytest.fixture(scope="module")
def toggle_jax(ckpt_dir):
    return _jax_run(TOGGLE, ckpt_dir)


@pytest.fixture(scope="module")
def toggle_port(ckpt_dir):
    return _port_run(TOGGLE, checkpoint_path=str(ckpt_dir / "port.npz"),
                     checkpoint_every=CKPT_EVERY)


def _assert_within_contract(j, t, fsp_tol):
    assert t.stats.iflag == 0
    assert np.all(np.isfinite(t.probabilities))
    assert t.wsum >= 1.0 - fsp_tol
    assert abs(t.wsum - j.wsum) <= fsp_tol
    assert _l1(j, t) <= 2 * fsp_tol


def test_toggle_matches_jax(toggle_jax, toggle_port):
    _, j = toggle_jax
    _report("toggle t=5", j, toggle_port)
    _assert_within_contract(j, toggle_port, TOGGLE["fsp_tol"])
    assert toggle_port.box.axis_of_species == j.box.axis_of_species


def test_goutsias_matches_jax():
    _, j = _jax_run(GOUTSIAS)
    t = _port_run(GOUTSIAS)
    _report("goutsias t=1", j, t)
    _assert_within_contract(j, t, GOUTSIAS["fsp_tol"])
    assert t.box.volume == j.box.volume


def test_float32_toggle_within_contract(toggle_jax):
    """dtype=float32 certifies fsp_tol (2e-5, above the f32 minimum) and
    tracks the float64 JAX answer within the two budgets."""
    _, j = toggle_jax
    case = dict(TOGGLE, fsp_tol=2e-5)
    solver = BoxCmeSolver(tlib.toggle_file_model(),
                          SolverConfig(dtype="float32"), device="cpu")
    r = solver.solve(case["t"], case["x0"], fsp_tol=case["fsp_tol"],
                     krylov_tol=case["krylov_tol"])
    assert solver.dtype == torch.float32
    assert r.stats.iflag == 0
    assert 1.0 - r.wsum <= 2e-5 + 1e-9
    assert r.stats.mass_spent <= 2e-5
    assert _l1(j, r) <= TOGGLE["fsp_tol"] + 2 * case["fsp_tol"]


def test_jax_checkpoint_resumes_in_port(toggle_jax, ckpt_dir):
    """JAX wrote a mid-solve snapshot; the port resumes it to t=5 within
    fsp_tol of the uninterrupted JAX run."""
    _, j = toggle_jax
    path = ckpt_dir / "jax.npz"
    with np.load(path) as z:
        assert 0 < int(z["carry_nstep"]) < j.stats.nstep
    r = solve_cme_box(tlib.toggle_file_model(), 0.0, resume_from=str(path),
                      config=SolverConfig(fused_steps=False), device="cpu")
    assert r.t == TOGGLE["t"] and r.stats.t_final == pytest.approx(r.t)
    _assert_within_contract(j, r, TOGGLE["fsp_tol"])


def test_port_checkpoint_resumes_in_jax(toggle_jax, toggle_port, ckpt_dir):
    """The reverse: the port's mid-solve snapshot resumes in the JAX
    solver (the fixture's instance, whose compiled geometries are warm)."""
    solver, j = toggle_jax
    path = ckpt_dir / "port.npz"
    with np.load(path) as z:
        assert 0 < int(z["carry_nstep"]) < toggle_port.stats.nstep
        assert z["carry_nmult"].dtype == np.int32
        assert z["carry_orderold"].dtype == np.bool_
    r = solver.solve(0.0, resume_from=str(path))
    assert r.t == TOGGLE["t"]
    _assert_within_contract(j, r, TOGGLE["fsp_tol"])


def test_growth_beyond_max_box_volume_raises():
    """Box growth past max_box_volume raises OverflowError in the stepwise
    loop, as in JAX.  (The fused loop of both packages grows only axes
    that may still grow and truncates at the others' faces.)"""
    cfg = SolverConfig(max_box_volume=1 << 10, fused_steps=False)
    with pytest.raises(OverflowError, match="max_box_volume"):
        solve_cme_box(tlib.toggle_file_model(), 5.0, [[0, 0]],
                      config=cfg, device="cpu")


@pytest.mark.slow
def test_toggle_reference_driver_matches_jax():
    """TestSolverFromFile: toggle t=1000 at (1e-4, 1e-10).  Too long for
    the CPU tier-1 run; chip_smoke.py runs the port's half on the GPU."""
    case = dict(name="toggle", t=1000.0, x0=[[0, 0]], fsp_tol=1e-4,
                krylov_tol=1e-10)
    _, j = _jax_run(case)
    t = _port_run(case)
    _report("toggle t=1000", j, t)
    _assert_within_contract(j, t, case["fsp_tol"])
