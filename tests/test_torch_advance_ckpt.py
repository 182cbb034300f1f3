"""Checkpoints of fused box solves, in both packages, on the CPU.

A checkpointed fused solve ends a segment at least every
``checkpoint_every`` attempted steps, so its segments end on their budget
where an unchecked solve's would not: the two may take different steps
(the JAX package does the same; it is mirrored, not fixed).  A snapshot
written after a segment resumes in the port and in the JAX package alike.

Resuming a snapshot written at t_out: the JAX fused loop runs one more
attempted step of length 0, whose local error is NaN, and raises its
iflag=3 error; its stepwise loop returns the snapshot as it is.  The port
does the same in each loop."""

import numpy as np
import pytest
import torch

from krylovfspssa_tpu.boxsolver import BoxCmeSolver as JSolver
from krylovfspssa_tpu.config import SolverConfig as JConfig
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu_torch import BoxCmeSolver, SolverConfig
from krylovfspssa_tpu_torch.models import library as tlib

torch.set_num_threads(2)

CASE = dict(t=20.0, x0=[[0, 0]], fsp_tol=1e-5, krylov_tol=1e-10)
EVERY = 5
KEYS = ("nstep", "fsp_size", "m", "advanced", "expanded", "dropped")


def _l1(a, b):
    pa = {tuple(s): p for s, p in zip(a.states, a.probabilities)}
    pb = {tuple(s): p for s, p in zip(b.states, b.probabilities)}
    return sum(abs(pa.get(k, 0.0) - pb.get(k, 0.0)) for k in set(pa) | set(pb))


def _ints(res):
    return [tuple(getattr(r, k) for k in KEYS) for r in res.stats.records]


def _port(**kw):
    return BoxCmeSolver(tlib.bursting_gene_model(), SolverConfig(**kw),
                        device="cpu")


def _jax(**kw):
    return JSolver(jlib.bursting_gene_model(), JConfig(**kw))


def _solve(solver, path=None, every=EVERY, t=CASE["t"]):
    kw = {} if path is None else dict(checkpoint_path=str(path),
                                      checkpoint_every=every)
    return solver.solve(t, CASE["x0"], fsp_tol=CASE["fsp_tol"],
                        krylov_tol=CASE["krylov_tol"], **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fused_ckpt")
    port = _port()
    res = _solve(port, d / "port.npz")
    jres = _solve(_jax(), d / "jax.npz")
    return dict(dir=d, port=port, res=res, jax=jres)


def test_checkpoint_every_sets_the_segment_budget(runs):
    budgets = {k[-1] for k in runs["port"]._fns if k[0] == "adv"}
    assert budgets == {EVERY}
    plain = _port()
    _solve(plain)
    assert {k[-1] for k in plain._fns if k[0] == "adv"} == {1000}
    # the checkpointed trajectory is the JAX package's checkpointed one
    assert _ints(runs["res"]) == _ints(runs["jax"])
    assert runs["res"].box.shape == runs["jax"].box.shape
    assert _l1(runs["res"], runs["jax"]) <= CASE["fsp_tol"]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_segment_snapshot_resumes_in_both_packages(runs, writer, reader):
    path = runs["dir"] / f"{writer}.npz"
    with np.load(path) as z:
        nstep = int(z["carry_nstep"])
        assert float(z["t_out"]) == CASE["t"]
    ref = runs[writer if writer == "jax" else "res"]
    assert 0 < nstep < ref.stats.nstep
    solver = _port() if reader == "port" else _jax()
    r = solver.solve(0.0, resume_from=str(path))
    assert r.t == CASE["t"] and r.stats.t_final == pytest.approx(CASE["t"])
    assert r.stats.iflag == 0 and r.wsum >= 1.0 - CASE["fsp_tol"]
    assert r.stats.nstep == ref.stats.nstep
    assert _l1(r, ref) <= CASE["fsp_tol"]


@pytest.fixture(scope="module")
def at_t_out(tmp_path_factory):
    """Snapshots written at t_out (every step is a segment of one)."""
    d = tmp_path_factory.mktemp("done_ckpt")
    out = {}
    for name, solver in (("port", _port()), ("jax", _jax())):
        res = _solve(solver, d / f"{name}.npz", every=1, t=2.0)
        with np.load(d / f"{name}.npz") as z:
            assert float(z["carry_t_now"]) == float(z["t_out"]) == 2.0
            assert int(z["carry_nstep"]) == res.stats.nstep
        out[name] = (d / f"{name}.npz", res)
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fused_resume_at_completion_raises_as_jax(at_t_out, writer):
    path, _ = at_t_out[writer]
    with pytest.raises(RuntimeError) as jerr:
        _jax().solve(0.0, resume_from=str(path))
    with pytest.raises(RuntimeError) as terr:
        _port().solve(0.0, resume_from=str(path))
    assert "iflag=3" in str(terr.value)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stepwise_resume_at_completion_returns_the_snapshot(at_t_out,
                                                            writer):
    path, res = at_t_out[writer]
    j = _jax(fused_steps=False).solve(0.0, resume_from=str(path))
    r = _port(fused_steps=False).solve(0.0, resume_from=str(path))
    for out in (j, r):
        assert out.stats.records == [] and out.stats.iflag == 0
        assert out.stats.nstep == res.stats.nstep
        assert np.array_equal(out.w_flat, res.w_flat)
