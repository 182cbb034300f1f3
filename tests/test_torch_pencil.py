"""The port's pencil operator (ops/pencil.py) against the JAX package's and
against the port's gather-ELL SpMV, and the table solve on it.

Supports are ragged random state sets made from
``numpy.random.default_rng(seed)`` (the cases of tests/test_pencil.py).
The layout and the source-row tables equal the JAX arrays exactly; the
matvec equals JAX ``pencil_matvec`` and the port's ``spmv`` to 1e-12
relative in float64, for the host builder and the port's device builder.
A ``table_operator="pencil"`` solve with both packages' ``ssa_extend``
stubbed (the method of tests/test_torch_table_stub.py) is held against the
JAX pencil solve record for record; the operator selection is the JAX
package's off TPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu.ops import pencil as jpencil
from krylovfspssa_tpu_torch import SolverConfig
from krylovfspssa_tpu_torch import solver as tsolver
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.ops import pencil as tpencil
from krylovfspssa_tpu_torch.ops.operator import build_operator
from krylovfspssa_tpu_torch.ops.spmv import operator_nreactions, spmv
from krylovfspssa_tpu_torch.solver import CmeSolver, solve_cme
from krylovfspssa_tpu_torch.statespace.encoding import StateEncoder
from krylovfspssa_tpu_torch.statespace.table import StateTable

torch.set_num_threads(2)

CAP = (1 << 14) - 1

#: (model name, spans, seed): tests/test_pencil.py's cases
CASES = [
    ("bursting_gene", (2, 60), 0),
    ("toggle", (40, 300), 1),  # lane extent > 128: multi-row bases
    ("goutsias", (50, 40, 12, 3, 3, 3), 2),
]


def _models(name):
    j = {"bursting_gene": jlib.bursting_gene_model,
         "toggle": jlib.toggle_file_model,
         "goutsias": jlib.goutsias_model}[name]()
    t = {"bursting_gene": tlib.bursting_gene_model,
         "toggle": tlib.toggle_file_model,
         "goutsias": tlib.goutsias_model}[name]()
    return j, t


def _random_support(model, n_target, seed, spans):
    """A ragged random support: random states and their 1-step
    successors (tests/test_pencil.py)."""
    rng = np.random.default_rng(seed)
    d = model.n_species
    pts = np.stack([rng.integers(0, spans[s], size=n_target)
                    for s in range(d)], axis=1).astype(np.int64)
    stoich = np.asarray(model.stoichiometry, np.int64)
    succ = (pts[:, None, :] + stoich[None, :, :]).reshape(-1, d)
    allpts = np.concatenate([pts, succ], axis=0)
    allpts = allpts[(allpts >= 0).all(axis=1)]
    return np.unique(allpts, axis=0).astype(np.int32)


def _ell_y(model, states, xs):
    """The port's gather-ELL spmv at the states (the oracle)."""
    enc = StateEncoder.for_model(model.n_species, 10_000)
    t = StateTable.from_states(states, enc, 64, None)
    op = build_operator(
        torch.as_tensor(t.states), torch.as_tensor(t.sorted_keys),
        torch.as_tensor(t.sorted_to_row), t.n, model.propensities,
        model.stoichiometry, enc)
    rows = np.asarray(t.lookup_states(states))
    x = np.zeros(t.capacity)
    x[rows] = xs
    return spmv(op, torch.from_numpy(x)).numpy()[rows]


def _jax_pencil(jmodel, states, lane):
    layout = jpencil.build_pencil_layout(states, lane)
    op = jpencil.build_pencil_operator(
        layout, states, lambda s: np.asarray(jmodel.propensities(
            jnp.asarray(s))),
        np.asarray(jmodel.stoichiometry, np.int64), species_cap=CAP)
    return layout, op


def _device_build(tmodel, layout, dtype=torch.float64):
    """The port's device builder on the layout's unpadded tables."""
    src_a, src_b = tpencil.host_index_tables(layout, tmodel.stoichiometry)
    build = tpencil.make_pencil_operator_builder(
        tmodel, tmodel.stoichiometry, layout.lane_species, CAP, dtype, "cpu")
    return build(layout.bases, layout.row_base, layout.row_block, src_a,
                 src_b, layout.mask.reshape(-1), layout.n_states)


def _at_states(op_fn, layout, xs):
    x = np.zeros(layout.n_cells)
    x[layout.slot_of_state] = xs
    return np.asarray(op_fn(x))[layout.slot_of_state]


@pytest.mark.parametrize("name,spans,seed", CASES)
def test_layout_and_index_tables_equal_jax(name, spans, seed):
    """build_pencil_layout, _lookup_bases and host_index_tables: the JAX
    arrays exactly, for every lane choice."""
    jm, tm = _models(name)
    states = _random_support(tm, 400, seed, spans)
    for lane in [None, *range(tm.n_species)]:
        jl = jpencil.build_pencil_layout(states, lane)
        tl = tpencil.build_pencil_layout(states, lane)
        for f in jl._fields:
            assert np.array_equal(np.asarray(getattr(jl, f)),
                                  np.asarray(getattr(tl, f))), (lane, f)
        for a, b in zip(jpencil.host_index_tables(jl, jm.stoichiometry),
                        tpencil.host_index_tables(tl, tm.stoichiometry)):
            assert np.array_equal(a, b)
        q = jl.bases[::3] + 1
        assert np.array_equal(jpencil._lookup_bases(jl, q),
                              tpencil._lookup_bases(tl, q))


@pytest.mark.parametrize("builder", ["host", "device"])
@pytest.mark.parametrize("name,spans,seed", CASES)
def test_pencil_matvec_matches_jax_and_ell(name, spans, seed, builder):
    jm, tm = _models(name)
    states = _random_support(tm, 400, seed, spans)
    xs = np.random.default_rng(seed + 10).random(len(states))
    jl, jop = _jax_pencil(jm, states, None)
    tl = tpencil.build_pencil_layout(states)
    if builder == "host":
        op = tpencil.build_pencil_operator(
            tl, states, tm.propensities, tm.stoichiometry, CAP)
    else:
        op = _device_build(tm, tl)
    assert op.shifts == jop.shifts
    assert operator_nreactions(op) == tm.n_reactions
    before = tpencil.CALLS
    y = _at_states(lambda x: spmv(op, torch.from_numpy(x)).numpy(), tl, xs)
    assert tpencil.CALLS == before + 1
    y_j = _at_states(lambda x: jpencil.pencil_matvec(jop, jnp.asarray(x)),
                     jl, xs)
    np.testing.assert_allclose(y, y_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y, _ell_y(tm, states, xs), rtol=1e-12,
                               atol=1e-12)


def test_every_lane_choice():
    """Any lane species, including ones giving multi-row pencils and tiny
    extents (tests/test_pencil.py), host and device builders."""
    jm, tm = _models("goutsias")
    states = _random_support(tm, 200, 3, (160, 30, 8, 3, 3, 3))
    xs = np.random.default_rng(42).random(len(states))
    y_ref = _ell_y(tm, states, xs)
    for ls in range(tm.n_species):
        jl, jop = _jax_pencil(jm, states, ls)
        y_j = _at_states(lambda x: jpencil.pencil_matvec(jop,
                                                         jnp.asarray(x)),
                         jl, xs)
        tl = tpencil.build_pencil_layout(states, ls)
        for op in (tpencil.build_pencil_operator(
                tl, states, tm.propensities, tm.stoichiometry, CAP),
                _device_build(tm, tl)):
            y = _at_states(lambda x: tpencil.pencil_matvec(
                op, torch.from_numpy(x)).numpy(), tl, xs)
            np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12,
                                       err_msg=f"lane_species={ls}")
            np.testing.assert_allclose(y, y_j, rtol=1e-12, atol=1e-12)


def test_layout_multirow():
    """Bases whose lane extent exceeds 128 get several rows."""
    states = np.stack([np.arange(300, dtype=np.int32),
                       np.zeros(300, np.int32)], axis=1)
    layout = tpencil.build_pencil_layout(states, lane_species=0)
    assert layout.n_rows == 3
    assert layout.mask.sum() == 300
    r, lane = np.divmod(layout.slot_of_state, tpencil.LANES)
    np.testing.assert_array_equal(layout.row_block[r] * tpencil.LANES + lane,
                                  states[:, 0])


def test_device_builder_chunks_and_padding(monkeypatch):
    """The device builder gives the same fields whatever its cell chunk,
    on tables padded to a rows bucket (padding rows: base -1, no
    members), as the solver pads them; a shift of 128 lanes is refused."""
    jm, tm = _models("goutsias")
    states = _random_support(tm, 300, 5, (50, 40, 12, 3, 3, 3))
    tl = tpencil.build_pencil_layout(states)
    src_a, src_b = tpencil.host_index_tables(tl, tm.stoichiometry)
    rows, R = tl.n_rows, tm.n_reactions
    pad = 64 - rows % 64 + rows
    args = (
        np.concatenate([tl.bases, np.zeros((3, tm.n_species - 1),
                                           np.int32)]),
        np.concatenate([tl.row_base, np.full(pad - rows, -1, np.int32)]),
        np.concatenate([tl.row_block, np.zeros(pad - rows, np.int32)]),
        np.concatenate([src_a, np.full((R, pad - rows), -1, np.int32)], 1),
        np.concatenate([src_b, np.full((R, pad - rows), -1, np.int32)], 1),
        np.concatenate([tl.mask.reshape(-1),
                        np.zeros((pad - rows) * 128, bool)]),
        tl.n_states,
    )
    build = tpencil.make_pencil_operator_builder(
        tm, tm.stoichiometry, tl.lane_species, CAP, torch.float64, "cpu")
    whole = build(*args)
    monkeypatch.setattr(tpencil, "_CELL_CHUNK", 3 * tpencil.LANES)
    chunked = build(*args)
    for a, b in zip(whole.tensors(), chunked.tensors()):
        assert torch.equal(a, b)
    host = tpencil.build_pencil_operator(tl, states, tm.propensities,
                                         tm.stoichiometry, CAP)
    n = rows * tpencil.LANES
    np.testing.assert_allclose(whole.diag[:n].numpy(), host.diag.numpy(),
                               rtol=1e-13, atol=0)
    np.testing.assert_allclose(whole.pred_prop[:, :n].numpy(),
                               host.pred_prop.numpy(), rtol=1e-13, atol=0)
    assert not whole.diag[n:].any() and not whole.pred_prop[:, n:].any()
    wide = np.array([[0, 0], [1, 0]], np.int32)
    with pytest.raises(ValueError, match="lane width"):
        tpencil.host_index_tables(tpencil.build_pencil_layout(wide, 0),
                                  np.array([[128, 0]]))


# ------------------------------------------------------------- solves ----


def _identity(table, *args, **kwargs):
    return table, 0


def _records(res):
    return list(res.stats.records)


def _fields(r):
    return (r.nstep, r.fsp_size, r.m, r.advanced, r.expanded, r.dropped)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_pencil_solve_matches_jax_pencil_solve(monkeypatch, fused):
    """toggle t=5 with table_operator="pencil" and both packages'
    ``ssa_extend`` stubbed: the JAX pencil solve record for record (the
    same steps, FSP sizes and Krylov sizes; t, wsum and err_loc to 1e-9),
    and the same states and probabilities to 1e-10."""
    from krylovfspssa_tpu import solver as jsolver
    from krylovfspssa_tpu.config import SolverConfig as JConfig

    monkeypatch.setattr(jsolver, "ssa_extend", _identity)
    monkeypatch.setattr(tsolver, "ssa_extend", _identity)
    kw = dict(fsp_tol=1e-4, krylov_tol=1e-10)
    j = jsolver.solve_cme(jlib.toggle_file_model(), 5.0, [[0, 0]],
                          config=JConfig(table_operator="pencil",
                                         fused_steps=fused), **kw)
    calls = tpencil.CALLS
    t = solve_cme(tlib.toggle_file_model(), 5.0, [[0, 0]], device="cpu",
                  config=SolverConfig(table_operator="pencil",
                                      fused_steps=fused), **kw)
    assert tpencil.CALLS - calls >= t.stats.nmult > 0
    rj, rt = _records(j), _records(t)
    assert [_fields(a) for a in rj] == [_fields(b) for b in rt]
    for a, b in zip(rj, rt):
        assert b.t_now == pytest.approx(a.t_now, rel=1e-9)
        assert b.wsum == pytest.approx(a.wsum, rel=1e-9)
    assert np.array_equal(np.asarray(j.states), t.states)
    np.testing.assert_allclose(t.probabilities, np.asarray(j.probabilities),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("name,t_out", [("bursting_gene", 20.0),
                                        ("toggle", 30.0)])
def test_pencil_solve_matches_ell(name, t_out):
    """tests/test_pencil.py's end-to-end contract: the pencil solve agrees
    with the gather-ELL solve within solver error."""
    _, tm = _models(name)
    kw = dict(fsp_tol=1e-4, krylov_tol=1e-10, device="cpu")
    r_ell = solve_cme(tm, t_out, [[0, 0]],
                      config=SolverConfig(table_operator="ell"), **kw)
    r_pen = solve_cme(tm, t_out, [[0, 0]],
                      config=SolverConfig(table_operator="pencil"), **kw)
    assert r_pen.wsum >= 1.0 - 1e-4
    assert r_pen.wsum == pytest.approx(r_ell.wsum, abs=1e-6)
    d = {tuple(s): p for s, p in zip(r_ell.states, r_ell.probabilities)}
    for s, p in zip(r_pen.states, r_pen.probabilities):
        if p > 1e-9:
            assert d.get(tuple(s), 0.0) == pytest.approx(p, abs=1e-6)


def test_pencil_stepwise_and_checkpoint(tmp_path):
    """The pencil under fused_steps=False, and a checkpoint round trip:
    the snapshot (table rows, the one format) resumes in the port and in
    the JAX package."""
    from krylovfspssa_tpu.config import SolverConfig as JConfig
    from krylovfspssa_tpu.solver import CmeSolver as JSolver

    model = tlib.bursting_gene_model()
    cfg = SolverConfig(table_operator="pencil", fused_steps=False)
    full = CmeSolver(model, cfg, device="cpu").solve(
        20.0, [[0, 0]], fsp_tol=1e-4, krylov_tol=1e-8)
    assert full.wsum >= 1.0 - 1e-4
    path = str(tmp_path / "pencil_ck.npz")
    cfg2 = SolverConfig(table_operator="pencil")
    CmeSolver(model, cfg2, device="cpu").solve(
        20.0, [[0, 0]], fsp_tol=1e-4, krylov_tol=1e-8,
        checkpoint_path=path, checkpoint_every=5)
    resumed = CmeSolver(model, cfg2, device="cpu").solve(20.0,
                                                         resume_from=path)
    assert resumed.stats.t_final >= 20.0
    assert resumed.wsum == pytest.approx(full.wsum, abs=1e-5)
    j = JSolver(jlib.bursting_gene_model(),
                JConfig(table_operator="pencil")).solve(20.0,
                                                        resume_from=path)
    assert j.wsum == pytest.approx(full.wsum, abs=1e-5)


def test_operator_selection():
    """The JAX package's selection off TPU: "auto" and "ell" take ELL;
    "pencil" and any other value build the pencil; under a mesh every
    value takes ELL (a mesh of one rank here)."""
    from krylovfspssa_tpu_torch.ops.operator import CmeOperator
    from krylovfspssa_tpu_torch.parallel.sharded import ShardMesh

    model = tlib.toggle_file_model()
    enc = StateEncoder.for_model(2, 10_000)
    table = StateTable.from_states(
        np.array([[0, 0], [1, 0], [0, 1], [3, 2]], np.int32), enc, 64)
    kinds = {}
    for mode in ("auto", "ell", "pencil", "lanes"):
        for mesh in (None, ShardMesh("cpu")):
            s = CmeSolver(model, SolverConfig(table_operator=mode),
                          device="cpu", mesh=mesh)
            s._props_fn = functools.partial(
                model.propensities, params=torch.as_tensor(
                    np.asarray(model.parameters), dtype=torch.float64))
            s._choose_operator(table)
            op, vl = s._operator(table)
            kinds[mode, mesh is None] = type(op)
            assert vl.take(vl.put(np.arange(4.0))).tolist() == [0, 1, 2, 3]
    assert kinds["auto", True] is CmeOperator
    assert kinds["ell", True] is CmeOperator
    assert kinds["pencil", True] is tpencil.PencilOperator
    assert kinds["lanes", True] is tpencil.PencilOperator
    assert all(kinds[m, False] is CmeOperator
               for m in ("auto", "ell", "pencil", "lanes"))
