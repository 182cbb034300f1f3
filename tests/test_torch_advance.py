"""The fused box main loop (``krylov/advance.py`` and
``BoxCmeSolver._solve_fused``) of the PyTorch port against its stepwise
loop and against the JAX package's fused loop, on the CPU:

  * bursting_gene t=20: the port's fused loop equals its stepwise loop
    (the analog of tests/test_box.py::test_fused_loop_matches_host_loop)
    and has the JAX fused loop's per-step records;
  * models/birth_death_model.input with ``max_steps_per_call=5``: the
    segments end on their budget and the box shrinks, which the stepwise
    loop never does; the port has the JAX fused counts;
  * the growth-stall guard and the EVENT_FAIL messages, with a stubbed
    segment function in both packages;
  * the face test and the constants shared with the JAX module.

Checkpoints of fused solves are in tests/test_torch_advance_ckpt.py."""

import _birth_death
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovfspssa_tpu import load_model as jload_model
from krylovfspssa_tpu.boxsolver import BoxCmeSolver as JSolver
from krylovfspssa_tpu.boxspace.box import BoxSpace as JBox
from krylovfspssa_tpu.config import SolverConfig as JConfig
from krylovfspssa_tpu.krylov import advance as jadv
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu_torch import (
    BoxCmeSolver,
    SolverConfig,
    load_model,
    solve_cme_box,
)
from krylovfspssa_tpu_torch.boxspace.box import BoxSpace
from krylovfspssa_tpu_torch.cli import main as cli_main
from krylovfspssa_tpu_torch.krylov import advance as tadv
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.utils import trace

torch.set_num_threads(2)

BURSTING = dict(t=20.0, x0=[[0, 0]], fsp_tol=1e-5, krylov_tol=1e-10)

BD = dict(_birth_death.CASE, params=_birth_death.PARAMS)
#: the JAX fused loop's counts on this case with max_steps_per_call=5 (a
#: CPU in float64): steps, final box, FSP states, box shrinks
BD_JAX_BUDGET5 = (58, (64,), 40, 3)

RECORD_INTS = ("nstep", "fsp_size", "m", "advanced", "expanded", "dropped")
RECORD_FLOATS = ("t_step", "t_new", "t_now", "wsum")


def _l1(a, b):
    pa = {tuple(s): p for s, p in zip(a.states, a.probabilities)}
    pb = {tuple(s): p for s, p in zip(b.states, b.probabilities)}
    return sum(abs(pa.get(k, 0.0) - pb.get(k, 0.0)) for k in set(pa) | set(pb))


def _count_shrinks(solver):
    """Wrap ``solver._shrink_if_loose`` to count the calls that changed the
    box (the same method name in both packages)."""
    seen = []
    inner = solver._shrink_if_loose

    def spy(box, *arrays):
        out = inner(box, *arrays)
        if out[0] is not box:
            seen.append(out[0].shape)
        return out

    solver._shrink_if_loose = spy
    return seen


@pytest.fixture(scope="module")
def bursting():
    kw = dict(fsp_tol=BURSTING["fsp_tol"], krylov_tol=BURSTING["krylov_tol"])
    stepwise = solve_cme_box(tlib.bursting_gene_model(), BURSTING["t"],
                             BURSTING["x0"],
                             config=SolverConfig(fused_steps=False),
                             device="cpu", **kw)
    with trace.recording() as rec:
        fused = solve_cme_box(tlib.bursting_gene_model(), BURSTING["t"],
                              BURSTING["x0"], device="cpu", **kw)
    jax_fused = JSolver(jlib.bursting_gene_model(), JConfig()).solve(
        BURSTING["t"], BURSTING["x0"], **kw)
    return stepwise, fused, jax_fused, rec.spans


def test_fused_loop_matches_stepwise_loop(bursting):
    stepwise, fused, _, _ = bursting
    assert fused.stats.nstep == stepwise.stats.nstep
    assert fused.stats.final_fsp_size == stepwise.stats.final_fsp_size
    d_u = {tuple(s): p for s, p in zip(stepwise.states,
                                       stepwise.probabilities)}
    d_f = {tuple(s): p for s, p in zip(fused.states, fused.probabilities)}
    for k in set(d_u) | set(d_f):
        assert d_f.get(k, 0.0) == pytest.approx(d_u.get(k, 0.0), abs=1e-14)


def test_fused_loop_matches_jax_fused_records(bursting):
    """Equal nstep, box and per-step records.  ``err_loc``, the local
    error estimate, is a difference of nearly equal terms at round-off
    level; it is held to a tenth of krylov_tol (a step is rejected only
    above 1.2 * krylov_tol * t_step), the other floats to 1e-12."""
    _, fused, jax_fused, spans = bursting
    assert fused.stats.nstep == jax_fused.stats.nstep
    assert fused.box.shape == jax_fused.box.shape
    assert fused.stats.n_drops == jax_fused.stats.n_drops
    assert fused.stats.n_expansions == jax_fused.stats.n_expansions
    recs, jrecs = fused.stats.records, jax_fused.stats.records
    assert len(recs) == len(jrecs) > 0
    for a, b in zip(recs, jrecs):
        for k in RECORD_INTS:
            assert getattr(a, k) == getattr(b, k), (a, b, k)
        for k in RECORD_FLOATS:
            assert getattr(a, k) == pytest.approx(getattr(b, k), rel=1e-12,
                                                  abs=1e-300), (a, b, k)
        assert abs(a.err_loc - b.err_loc) <= 0.1 * BURSTING["krylov_tol"]
    # the fused loop's segments are spanned (the records carry no wall)
    assert spans["segment"][0] > 0
    assert _l1(fused, jax_fused) <= BURSTING["fsp_tol"]


def _bd_models():
    jm, tm = jload_model(_birth_death.PATH), load_model(_birth_death.PATH)
    jm.reset_parameters(BD["params"])
    tm.reset_parameters(BD["params"])
    return jm, tm


def test_budget_segments_shrink_the_box_as_jax_does():
    jm, tm = _bd_models()
    kw = dict(fsp_tol=BD["fsp_tol"], krylov_tol=BD["krylov_tol"])
    jsolver = JSolver(jm, JConfig(max_steps_per_call=5))
    jshrinks = _count_shrinks(jsolver)
    j = jsolver.solve(BD["t"], BD["x0"], **kw)
    solver = BoxCmeSolver(tm, SolverConfig(max_steps_per_call=5),
                          device="cpu")
    shrinks = _count_shrinks(solver)
    r = solver.solve(BD["t"], BD["x0"], **kw)
    assert (j.stats.nstep, j.box.shape, j.stats.final_fsp_size,
            len(jshrinks)) == BD_JAX_BUDGET5
    assert (r.stats.nstep, r.box.shape, r.stats.final_fsp_size,
            len(shrinks)) == BD_JAX_BUDGET5
    assert shrinks == jshrinks
    assert r.stats.iflag == 0 and r.wsum >= 1.0 - BD["fsp_tol"]
    assert _l1(r, j) <= BD["fsp_tol"]
    assert len(r.stats.records) == len(j.stats.records)
    # the geometries the solve passed through stay cached
    assert set(solver.cached_geometries) >= {(64,), (128,), (256,)}


@pytest.mark.parametrize("budget", [5, 1000])
def test_fused_birth_death_matches_the_closed_form(budget):
    """Budget segments that shrink the box keep the solve within fsp_tol
    of the exact law (L1 over every count)."""
    _, tm = _bd_models()
    r = BoxCmeSolver(tm, SolverConfig(max_steps_per_call=budget),
                     device="cpu").solve(BD["t"], BD["x0"],
                                         fsp_tol=BD["fsp_tol"],
                                         krylov_tol=BD["krylov_tol"])
    n_max = int(r.states[:, 0].max()) + 400
    got = np.zeros(n_max + 1)
    got[r.states[:, 0]] = r.probabilities
    assert np.abs(got - _birth_death.exact(n_max)).sum() <= BD["fsp_tol"]


def test_stepwise_loop_never_shrinks():
    _, tm = _bd_models()
    solver = BoxCmeSolver(tm, SolverConfig(fused_steps=False,
                                           max_steps_per_call=5),
                          device="cpu")
    shrinks = _count_shrinks(solver)
    r = solver.solve(BD["t"], BD["x0"], fsp_tol=BD["fsp_tol"],
                     krylov_tol=BD["krylov_tol"])
    assert shrinks == [] and r.box.shape == (512,)
    assert r.wsum >= 1.0 - BD["fsp_tol"]


@pytest.mark.parametrize("fused", [True, False])
def test_config_selects_the_loop(fused, monkeypatch):
    """``fused_steps`` (default True) picks the loop: only the fused one
    asks for segment functions."""
    solver = BoxCmeSolver(tlib.toggle_file_model(),
                          SolverConfig(fused_steps=fused), device="cpu")
    assert SolverConfig().fused_steps is True
    calls = []
    inner = solver._advance
    monkeypatch.setattr(solver, "_advance",
                        lambda *a: calls.append(a) or inner(*a))
    r = solver.solve(1.0, [[0, 0]], fsp_tol=1e-4, krylov_tol=1e-8)
    assert r.stats.iflag == 0
    assert bool(calls) == fused


def test_cli_no_fused_selects_the_stepwise_loop(monkeypatch, capsys):
    from krylovfspssa_tpu_torch import boxsolver

    seen = []

    def solve(model, t, x0, config=None, **kw):
        seen.append(config.fused_steps)
        raise SystemExit(0)

    monkeypatch.setattr(boxsolver, "solve_cme_box", solve)
    for argv, want in ((["--no-fused"], False), ([], True)):
        with pytest.raises(SystemExit):
            cli_main(["solve", "bursting_gene", "--t", "1", "--device",
                      "cpu", *argv])
        assert seen.pop() is want


# ------------------------------------------------ stubbed segments --


def _jax_stub(event, iflag, nstep):
    def adv(w, mask, carry, t_out, fsptol, krytol):
        return jadv.AdvanceState(
            w=w, mask=mask,
            carry=carry._replace(iflag=jnp.asarray(iflag, jnp.int32),
                                 nstep=jnp.asarray(nstep, jnp.int32)),
            event=jnp.asarray(event, jnp.int32),
            steps=jnp.asarray(0, jnp.int32),
            records=jnp.zeros((1, len(jadv.RECORD_FIELDS))),
            n_drops=jnp.asarray(0, jnp.int32),
            n_expansions=jnp.asarray(0, jnp.int32),
        )
    return adv


def _port_stub(event, iflag, nstep, calls):
    def adv(w, mask, carry, t_out, fsptol, krytol):
        calls.append(1)
        return tadv.AdvanceState(
            w=w, mask=mask,
            carry=carry._replace(iflag=np.int32(iflag),
                                 nstep=np.int32(nstep)),
            event=event, steps=0,
            records=[],
            n_drops=0, n_expansions=0,
        )
    return adv


def _stubbed_errors(event, iflag, nstep):
    """The error each package's fused loop raises when every segment
    returns ``event`` with no step; the port's segment count."""
    jsolver = JSolver(jlib.bursting_gene_model(), JConfig())
    jsolver._advance = lambda box, growable: _jax_stub(event, iflag, nstep)
    with pytest.raises(RuntimeError) as jerr:
        jsolver.solve(1.0, [[0, 0]], fsp_tol=1e-4, krylov_tol=1e-8)
    calls = []
    solver = BoxCmeSolver(tlib.bursting_gene_model(), device="cpu")
    solver._advance = lambda box, growable: _port_stub(event, iflag, nstep,
                                                       calls)
    with pytest.raises(RuntimeError) as terr:
        solver.solve(1.0, [[0, 0]], fsp_tol=1e-4, krylov_tol=1e-8)
    return str(jerr.value), str(terr.value), len(calls)


def test_growth_stall_guard():
    """16 GROW segments in a row that accept no step, once integration
    has started (nstep >= 1), raise the JAX message."""
    jmsg, msg, n = _stubbed_errors(tadv.EVENT_GROW, 0, 1)
    assert msg == jmsg
    assert msg.startswith("16 consecutive state-space growths")
    assert n == 16


@pytest.mark.parametrize("iflag,needle", [(2, "IFLAG=2"), (3, "iflag=3")])
def test_event_fail_messages(iflag, needle):
    jmsg, msg, n = _stubbed_errors(tadv.EVENT_FAIL, iflag, 0)
    assert msg == jmsg and needle in msg
    assert n == 1


# ------------------------------------------------------- pieces ------


def test_constants_match_jax():
    assert tadv.RECORD_FIELDS == jadv.RECORD_FIELDS
    for name in ("EVENT_NONE", "EVENT_DONE", "EVENT_GROW", "EVENT_BUDGET",
                 "EVENT_FAIL", "EVENT_EXPAND"):
        assert getattr(tadv, name) == getattr(jadv, name), name
    assert tadv.AdvanceState._fields == jadv.AdvanceState._fields


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_touch_flags_match_jax(seed):
    """Only growable axes are tested, over a band as wide as the largest
    |nu| of the species (Goutsias has moves of 2)."""
    model = tlib.goutsias_model()
    x0 = np.array([[2, 6, 0, 2, 0, 0]])
    tbox = BoxSpace.for_model(model.stoichiometry, x0, 2)
    jbox = JBox.for_model(jlib.goutsias_model().stoichiometry, x0, 2)
    rng = np.random.default_rng(seed)
    for growable in [(), (0,), (1, 3), tuple(range(6))]:
        for frac in (0.0, 0.001, 0.05):
            mask = rng.random(tbox.volume) < frac
            want = bool(jadv._touch_flags(jbox, jnp.asarray(mask), growable))
            got = tadv._touch_flags(
                torch.from_numpy(mask),
                tadv._face_band(tbox, growable, torch.device("cpu")))
            assert got.dtype == torch.bool and bool(got) == want
