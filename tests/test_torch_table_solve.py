"""Table-backend solves of the PyTorch port with SSA expansion on, on the
CPU.  The port's SSA walks draw from its own random stream, so these
solves are held to the FSP tolerance, not step for step
(tests/test_torch_table_stub.py holds the loops step for step):

  * toggle t=1 and t=10 (the JAX package's dense-oracle scenario,
    tests/test_solver.py): L1 <= 2 x fsp_tol against the JAX ``solve_cme``
    and against the dense matrix-exponential oracle;
  * Goutsias t=1 (reference examples/transcr6d.f90, keys of two words):
    against the JAX table backend and the port's box backend;
  * bursting_gene against its oracle, the point-probability query, a
    5-species model whose keys take two words, the NaN-step recovery
    (``_sanitize_carry``) against the JAX package's, and the entry
    points' refusals (a device other than the mesh's, no card).
"""

import numpy as np
import pytest
import torch
from test_solver import dense_solution

import krylovfspssa_tpu.solver as jsolver
from krylovfspssa_tpu.config import SolverConfig as JConfig
from krylovfspssa_tpu.krylov.stepper import initial_carry as j_initial_carry
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu_torch import CmeSolver, SolverConfig, solve_cme
from krylovfspssa_tpu_torch import solve_cme_box
from krylovfspssa_tpu_torch.krylov.stepper import carry_from_numpy
from krylovfspssa_tpu_torch.models import library as tlib

torch.set_num_threads(2)

GOUTSIAS_X0 = [[2, 6, 0, 2, 0, 0]]


def _l1(a, b):
    pa = {tuple(s): p for s, p in zip(a.states, a.probabilities)}
    pb = {tuple(s): p for s, p in zip(b.states, b.probabilities)}
    return sum(abs(pa.get(k, 0.0) - pb.get(k, 0.0)) for k in set(pa) | set(pb))


def _l1_oracle(res, states_o, p_o):
    lut = {tuple(s): p for s, p in zip(res.states, res.probabilities)}
    inside = {tuple(s) for s in states_o}
    l1 = sum(abs(lut.get(tuple(s), 0.0) - p) for s, p in zip(states_o, p_o))
    return l1 + sum(p for s, p in lut.items() if s not in inside)


@pytest.mark.parametrize("t", [1.0, 10.0])
def test_toggle_vs_jax_and_dense_oracle(t):
    fsp_tol = 1e-4
    kw = dict(fsp_tol=fsp_tol, krylov_tol=1e-10)
    got = solve_cme(tlib.toggle_file_model(), t, [[0, 0]],
                    config=SolverConfig(init_capacity=256, seed=1),
                    device="cpu", **kw)
    want = jsolver.solve_cme(jlib.toggle_file_model(), t, [[0, 0]],
                             config=JConfig(init_capacity=256, seed=1), **kw)
    assert got.stats.iflag == 0 and got.stats.n_expansions >= 1
    assert 1 - fsp_tol <= got.wsum <= 1 + 1e-12
    assert _l1(got, want) <= 2 * fsp_tol
    states_o, p_o = dense_solution(jlib.toggle_file_model(), (110, 200),
                                   (0, 0), t)
    assert p_o.sum() > 1 - 1e-9
    assert _l1_oracle(got, states_o, p_o) <= 2 * fsp_tol


def test_bursting_gene_vs_dense_oracle_and_queries():
    res = solve_cme(tlib.bursting_gene_model(), 50.0, [[0, 0]],
                    fsp_tol=1e-5, krylov_tol=1e-10,
                    config=SolverConfig(init_capacity=64, seed=2),
                    device="cpu")
    states_o, p_o = dense_solution(jlib.bursting_gene_model(), (2, 40),
                                   (0, 0), 50.0)
    assert _l1_oracle(res, states_o, p_o) <= 2e-5
    assert res.probability([0, 0]) > 0
    assert res.probability([0, 9999]) == 0.0
    s = res.stats
    assert s.nstep >= 1 and s.nmult > 0 and s.final_fsp_size == len(
        res.states)
    marg = res.marginal(1)
    assert abs(marg.sum() - res.wsum) < 1e-12
    np.testing.assert_allclose(res.mean()[1],
                               np.arange(marg.size) @ marg / res.wsum)
    assert np.all(res.variance() >= 0)


def test_goutsias_vs_jax_and_box():
    kw = dict(fsp_tol=1e-6, krylov_tol=1e-8)
    got = solve_cme(tlib.goutsias_model(), 1.0, GOUTSIAS_X0, device="cpu",
                    **kw)
    assert got.table.encoder.n_words == 2
    assert got.stats.iflag == 0 and got.wsum >= 1 - 1e-6
    want = jsolver.solve_cme(jlib.goutsias_model(), 1.0, GOUTSIAS_X0, **kw)
    assert _l1(got, want) <= 2e-6
    box = solve_cme_box(tlib.goutsias_model(), 1.0, GOUTSIAS_X0,
                        device="cpu", **kw)
    assert _l1(got, box) <= 2e-6
    # the table covers the support with far fewer states than the box
    assert got.stats.final_fsp_size < box.stats.final_fsp_size


def test_wide_key_solve():
    res = solve_cme(tlib.ge5d_model(), 0.3, [[0, 0, 0, 0, 0]],
                    fsp_tol=1e-4, krylov_tol=1e-8, device="cpu")
    assert res.table.encoder.n_words == 2
    assert res.stats.nstep >= 1 and res.wsum >= 1 - 1e-4


def test_sanitize_carry_matches_jax():
    """A NaN-poisoned carry is rebuilt as the JAX package rebuilds it."""
    import jax.numpy as jnp

    w = np.zeros(16)
    w[:4] = [0.5, 0.25, 0.125, 0.125]
    jc = j_initial_carry(0.7, 5.0, 1e-10, 1.0, 10)._replace(
        t_now=jnp.asarray(1.5), t_new=jnp.asarray(float("nan")),
        omega=jnp.asarray(float("nan")), nstep=jnp.asarray(7, jnp.int32),
        nmult=jnp.asarray(300, jnp.int32), iflag=jnp.asarray(3, jnp.int32),
        m_new=jnp.asarray(23, jnp.int32))
    tc = carry_from_numpy(jc._asdict())
    jsol = jsolver.CmeSolver(jlib.toggle_file_model(), JConfig())
    want = jsol._sanitize_carry(jc, jnp.asarray(w), jnp.asarray(5.0),
                                jnp.asarray(1e-10))
    tsol = CmeSolver(tlib.toggle_file_model(), device="cpu")
    got = tsol._sanitize_carry(tc, torch.as_tensor(w), 5.0, 1e-10)
    for k, v in want._asdict().items():
        np.testing.assert_allclose(float(getattr(got, k)), float(v),
                                   rtol=1e-15, err_msg=k)
    assert int(got.iflag) == 0 and np.isfinite(got.t_new)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_nan_steps_reset_then_fail(fused, monkeypatch):
    """A step that ends with iflag=3 gets its carry rebuilt and the solve
    goes on; the sixth such step raises (both loops)."""
    solver = CmeSolver(tlib.bursting_gene_model(),
                       SolverConfig(fused_steps=fused), device="cpu")
    poison = {"left": 1}
    inner = solver._step if not fused else None

    def poisoned(res):
        if poison["left"] > 0:
            poison["left"] -= 1
            return res._replace(carry=res.carry._replace(iflag=np.int32(3)),
                                advanced=False, iexpand=False, dsum=0.0)
        return res

    if fused:
        from krylovfspssa_tpu_torch.krylov import advance as adv

        real = adv.make_masked_table_step

        def wrapped(*a, **k):
            step = real(*a, **k)
            return lambda *args: poisoned(step(*args))

        monkeypatch.setattr(adv, "make_masked_table_step", wrapped)
    else:
        monkeypatch.setattr(solver, "_step",
                            lambda *args: poisoned(inner(*args)))
    res = solver.solve(5.0, [[0, 0]], fsp_tol=1e-5, krylov_tol=1e-10)
    assert res.stats.iflag == 0 and res.wsum >= 1 - 1e-5
    poison["left"] = 6
    with pytest.raises(RuntimeError, match="five times"):
        solver.solve(5.0, [[0, 0]], fsp_tol=1e-5, krylov_tol=1e-10)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_expansions_without_progress_raise(fused, monkeypatch):
    """A solve whose steps stop advancing and keep asking for states (a
    criterion no step can meet) fails at the 16th expansion in a row at
    one t, in both loops, instead of expanding the table without end."""
    from krylovfspssa_tpu_torch.krylov import advance as adv

    real = adv.make_masked_table_step
    expansions = []

    def wrapped(*a, **k):
        step = real(*a, **k)

        def run(oa, w, carry, *rest):
            res = step(oa, w, carry, *rest)
            if int(carry.nstep) < 3:
                return res
            # from the third accepted step on: abandoned, expand
            expansions.append(float(carry.t_now))
            return res._replace(w=w, carry=carry, advanced=False,
                                iexpand=True, dsum=0.0)

        return run

    monkeypatch.setattr(adv, "make_masked_table_step", wrapped)
    solver = CmeSolver(tlib.bursting_gene_model(),
                       SolverConfig(fused_steps=fused), device="cpu")
    with pytest.raises(RuntimeError, match="16 consecutive state-space "
                       "expansions without an accepted step") as err:
        solver.solve(5.0, [[0, 0]], fsp_tol=1e-5, krylov_tol=1e-10)
    # the stubbed steps' expansions, after at most one of the solve's own
    # at the same t
    assert 15 <= len(expansions) <= 16 and len(set(expansions)) == 1
    assert f"at t={expansions[0]:g} " in str(err.value)


def test_refusals():
    """What the table entry points refuse: a device other than the
    mesh's, a resume-less solve without initial states, and (without a
    card) the default device.  The pencil operator and a mesh are
    accepted: the pencil solves within fsp_tol of ELL."""
    from krylovfspssa_tpu_torch.parallel.sharded import ShardMesh

    model = tlib.toggle_file_model()
    kw = dict(fsp_tol=1e-4, krylov_tol=1e-8, device="cpu")
    rp = solve_cme(model, 1.0, [[0, 0]],
                   config=SolverConfig(table_operator="pencil"), **kw)
    re_ = solve_cme(model, 1.0, [[0, 0]], **kw)
    assert rp.wsum == pytest.approx(re_.wsum, abs=1e-4)
    assert CmeSolver(model, mesh=ShardMesh("cpu"), device="cpu").mesh.size == 1
    with pytest.raises(ValueError, match="not the mesh's"):
        CmeSolver(model, mesh=ShardMesh("cpu"), device="cuda")
    with pytest.raises(ValueError, match="initial_states"):
        solve_cme(model, 1.0, None, device="cpu")
    # the entry points default to the card: without one they fail
    if torch.cuda.is_available():
        assert CmeSolver(model).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            solve_cme(model, 1.0, [[0, 0]])
