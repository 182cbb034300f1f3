"""The row-sharded table backend (``CmeSolver(mesh=...)``,
parallel/sharded.py's table half) on gloo ranks: each a spawned process
(parallel/multihost.py ``spawn``), joined within 300 s.

On 2 and 4 ranks: ``sharded_matvec`` against the port's ``spmv`` and the
JAX package's ``sharded_matvec`` on the 8 virtual devices of
tests/conftest.py (1e-12 relative); the bursting_gene t=10 solve in both
loops against the one-rank port and the JAX mesh solve (the contract of
tests/test_multidevice.py::test_table_full_solve_shard_invariance); the
same solve with ``ssa_extend`` stubbed against the one-rank port record
for record (tests/test_torch_table_stub.py's method); the cross-rank table
check raising on a forced mismatch; a snapshot written by rank 0 resumed on
one device.  Operator inputs come from ``numpy.random.default_rng(seed)``.

The rank functions live at module level (spawned processes import them);
JAX is imported only inside the tests, so the ranks never load it.
"""

import numpy as np
import pytest
import torch

import krylovfspssa_tpu_torch.solver as tsolver
from krylovfspssa_tpu_torch import SolverConfig
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.ops.operator import build_operator
from krylovfspssa_tpu_torch.ops.spmv import spmv
from krylovfspssa_tpu_torch.parallel.multihost import spawn
from krylovfspssa_tpu_torch.parallel.sharded import (
    ShardMesh,
    operator_shardings,
    shard_operator,
    sharded_matvec,
    table_rows,
)
from krylovfspssa_tpu_torch.solver import CmeSolver, solve_cme
from krylovfspssa_tpu_torch.statespace.encoding import StateEncoder
from krylovfspssa_tpu_torch.statespace.expand import onestep_extend
from krylovfspssa_tpu_torch.statespace.table import StateTable

torch.set_num_threads(2)

SPAWN = dict(backend="gloo", timeout_s=300, threads=1)
#: tests/test_multidevice.py::test_table_full_solve_shard_invariance
SOLVE = dict(t=10.0, x0=[[0, 0]], fsp_tol=1e-4, krylov_tol=1e-8)
GOUTSIAS_X0 = np.array([[2, 6, 0, 2, 0, 0]], np.int32)


def _goutsias_table(n_rounds=3, capacity=256):
    """A reachable Goutsias state set (the dry run's operator)."""
    model = tlib.goutsias_model()
    enc = StateEncoder.for_model(model.n_species, 10_000)
    table = StateTable.from_states(GOUTSIAS_X0, enc, capacity)
    for _ in range(n_rounds):
        table, _ = onestep_extend(table, model.stoichiometry, None)
    return model, enc, table


def _operator(model, enc, table, rows=None):
    return build_operator(
        torch.as_tensor(table.states), torch.as_tensor(table.sorted_keys),
        torch.as_tensor(table.sorted_to_row), table.n, model.propensities,
        model.stoichiometry, enc, rows=rows)


def _x(table, seed):
    x = np.zeros(table.capacity)
    x[:table.n] = np.random.default_rng(seed).random(table.n)
    return x


def _identity(table, *args, **kwargs):
    return table, 0


def _records(res):
    return list(res.stats.records)


def _solve(fused, **kw):
    return solve_cme(tlib.bursting_gene_model(), SOLVE["t"], SOLVE["x0"],
                     fsp_tol=SOLVE["fsp_tol"], krylov_tol=SOLVE["krylov_tol"],
                     config=SolverConfig(fused_steps=fused), **kw)


def _rank(mesh, ckpt):
    """Every sharded table piece on this rank."""
    out = {}
    model, enc, table = _goutsias_table()
    z0, n = table_rows(mesh, table.capacity)
    op_l = _operator(model, enc, table, rows=(z0, n))
    whole = _operator(model, enc, table)
    out["rows_equal"] = all(torch.equal(a, b) for a, b in zip(
        op_l[:-1], shard_operator(whole, mesh)[:-1]))
    x = torch.from_numpy(_x(table, 1))
    out["y"] = sharded_matvec(mesh)(op_l, x[z0:z0 + n].clone()).numpy()
    for fused in (True, False):
        res = _solve(fused, mesh=mesh,
                     checkpoint_path=ckpt if fused else None,
                     checkpoint_every=5)
        out["ssa", fused] = (res, _records(res))
    tsolver.ssa_extend = _identity
    for fused in (True, False):
        res = _solve(fused, mesh=mesh)
        out["stub", fused] = (res, _records(res))
    # a forced mismatch: rank 1 holds one state more
    solver = CmeSolver(tlib.bursting_gene_model(), mesh=mesh)
    t2 = table
    if mesh.rank == 1:
        t2, _ = table.merge_keys(enc.encode_np(np.array([[9, 9, 9, 9, 9, 9]],
                                                        np.int32)),
                                 np.array([[9, 9, 9, 9, 9, 9]], np.int32))
    solver._check_table(table)
    try:
        solver._check_table(t2)
        out["mismatch"] = None
    except RuntimeError as e:
        out["mismatch"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world size -> every rank's results, and the rank-0 snapshots."""
    d = tmp_path_factory.mktemp("sharded_table")
    return {n: (spawn(_rank, ["cpu"] * n, (str(d / f"ck{n}.npz"),), **SPAWN),
                d / f"ck{n}.npz") for n in (2, 4)}


@pytest.fixture(scope="module")
def one_rank():
    import krylovfspssa_tpu_torch.solver as ts

    out = {("ssa", f): _solve(f, device="cpu") for f in (True, False)}
    real = ts.ssa_extend
    ts.ssa_extend = _identity
    try:
        out.update({("stub", f): _solve(f, device="cpu")
                    for f in (True, False)})
    finally:
        ts.ssa_extend = real
    return out


def _l1(a, b):
    pa = {tuple(s): p for s, p in zip(a.states, a.probabilities)}
    pb = {tuple(s): p for s, p in zip(b.states, b.probabilities)}
    return sum(abs(pa.get(k, 0.0) - pb.get(k, 0.0)) for k in set(pa) | set(pb))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matvec_matches_spmv_and_jax(ranks, n):
    """The ranks' rows of the operator are the bits of the whole
    operator's rows, and their sharded matvecs, concatenated, equal the
    one-device spmv and the JAX sharded_matvec on the same operator."""
    import jax.numpy as jnp

    from krylovfspssa_tpu.models import library as jlib
    from krylovfspssa_tpu.ops.operator import build_operator as j_build
    from krylovfspssa_tpu.parallel.sharded import make_mesh
    from krylovfspssa_tpu.parallel.sharded import sharded_matvec as j_mv
    from krylovfspssa_tpu.statespace.encoding import StateEncoder as JEnc

    outs, _ = ranks[n]
    assert all(o["rows_equal"] for o in outs)
    model, enc, table = _goutsias_table()
    x = _x(table, 1)
    y = np.concatenate([o["y"] for o in outs])
    ref = spmv(_operator(model, enc, table), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-14)
    jm = jlib.goutsias_model()
    jop = j_build(table.states, table.sorted_keys, table.sorted_to_row,
                  jnp.asarray(table.n, jnp.int32), jm.propensities,
                  jnp.asarray(np.asarray(jm.stoichiometry)),
                  JEnc.for_model(jm.n_species, 10_000), jnp.float64)
    yj = np.asarray(j_mv(make_mesh(8))(jop, jnp.asarray(x)))
    np.testing.assert_allclose(y, yj, rtol=1e-12, atol=1e-14)


def test_operator_shardings_split_rows():
    """operator_shardings gives this rank's row slices; a capacity that
    does not divide over the ranks is refused."""
    mesh = ShardMesh("cpu")
    sh = operator_shardings(mesh, 64)
    assert sh.diag == slice(0, 64) and sh.n is None
    mesh.size, mesh.rank = 4, 3
    assert table_rows(mesh, 64) == (48, 16)
    with pytest.raises(ValueError, match="does not divide over 4 ranks"):
        table_rows(mesh, 66)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_solve_matches_one_rank_and_jax(ranks, one_rank, n, fused):
    """bursting_gene t=10 with SSA on: every rank returns the same
    result, within the JAX mesh contract (wsum within 1e-6, every state
    within 1e-6) of the one-rank port (rank 0 draws the walks from the
    one-rank solve's stream), and within 2 * fsp_tol of the JAX package's
    mesh solve on 8 devices (its walks draw another stream, ROADMAP Queue
    C)."""
    from krylovfspssa_tpu.config import SolverConfig as JConfig
    from krylovfspssa_tpu.models import library as jlib
    from krylovfspssa_tpu.parallel.sharded import make_mesh
    from krylovfspssa_tpu.solver import solve_cme as j_solve

    outs, _ = ranks[n]
    res = [o["ssa", fused] for o in outs]
    assert all(rec == res[0][1] for _, rec in res)
    assert all(np.array_equal(r.probabilities, res[0][0].probabilities)
               for r, _ in res)
    r = res[0][0]
    assert r.stats.iflag == 0 and r.wsum >= 1.0 - SOLVE["fsp_tol"]
    j = j_solve(jlib.bursting_gene_model(), SOLVE["t"], SOLVE["x0"],
                fsp_tol=SOLVE["fsp_tol"], krylov_tol=SOLVE["krylov_tol"],
                config=JConfig(fused_steps=fused), mesh=make_mesh(8))
    ref = one_rank["ssa", fused]
    assert r.wsum == pytest.approx(ref.wsum, abs=1e-6)
    d1 = {tuple(s): p for s, p in zip(ref.states, ref.probabilities)}
    d2 = {tuple(s): p for s, p in zip(r.states, r.probabilities)}
    for k in set(d1) | set(d2):
        assert d2.get(k, 0.0) == pytest.approx(d1.get(k, 0.0), abs=1e-6)
    assert _l1(r, j) <= 2 * SOLVE["fsp_tol"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
@pytest.mark.parametrize("n", [2, 4])
def test_stubbed_sharded_solve_matches_one_rank(ranks, one_rank, n, fused):
    """With ``ssa_extend`` stubbed the sharded solve is the one-rank
    port's record for record (every integer field equal; t and wsum to
    1e-12 relative) and ends on the same states, within 1e-12."""
    outs, _ = ranks[n]
    r, rec = outs[0]["stub", fused]
    one = one_rank["stub", fused]
    rec1 = _records(one)
    ints = ("nstep", "fsp_size", "m", "advanced", "expanded", "dropped")
    assert [tuple(getattr(a, f) for f in ints) for a in rec] == \
        [tuple(getattr(a, f) for f in ints) for a in rec1]
    for a, b in zip(rec, rec1):
        assert a.t_now == pytest.approx(b.t_now, rel=1e-12)
        assert a.wsum == pytest.approx(b.wsum, rel=1e-12)
    assert np.array_equal(r.states, one.states)
    np.testing.assert_allclose(r.probabilities, one.probabilities, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("n", [2, 4])
def test_table_check_raises_on_mismatch(ranks, n):
    """The cross-rank table check passes on equal tables and raises on
    every rank when one rank's table differs."""
    outs, _ = ranks[n]
    assert all(o["mismatch"] and "tables differ" in o["mismatch"]
               for o in outs)


@pytest.mark.parametrize("n", [2, 4])
def test_rank0_snapshot_resumes_on_one_device(ranks, one_rank, n):
    """Rank 0's snapshot (the one-device format) resumes on one device of
    the port and in the JAX package, and ends within 2 * fsp_tol of the
    one-rank solve."""
    from krylovfspssa_tpu.solver import solve_cme as j_solve
    from krylovfspssa_tpu.models import library as jlib

    _, path = ranks[n]
    with np.load(path) as z:
        assert int(z["carry_nstep"]) >= 5
    ref = one_rank["ssa", True]
    r = solve_cme(tlib.bursting_gene_model(), 0.0, None, resume_from=str(
        path), device="cpu")
    j = j_solve(jlib.bursting_gene_model(), 0.0, None,
                resume_from=str(path))
    for res in (r, j):
        assert res.stats.t_final >= SOLVE["t"]
        assert _l1(res, ref) <= 2 * SOLVE["fsp_tol"]


def test_cli_table_devices(capsys):
    """kfs-torch solve --backend table --devices 2 --device cpu."""
    import json

    from krylovfspssa_tpu_torch.cli import main

    rc = main(["solve", "bursting_gene", "--t", "5", "--fsp-tol", "1e-4",
               "--backend", "table", "--devices", "2", "--device", "cpu",
               "--json"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["backend"] == "table" and rec["ranks"] == 2
    assert rec["t"] >= 5.0 and rec["wsum"] >= 1.0 - 1e-4
