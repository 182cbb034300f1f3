"""Fused row-sharded box solves (``BoxCmeSolver(mesh=...)`` with the
default ``fused_steps=True``, krylov/advance.py) over 2 gloo ranks on the
CPU, each a spawned process (parallel/multihost.py ``spawn``), against the
one-device fused solve of the port: toggle t=5, the birth-death model of
models/birth_death_model.input with a segment budget of 5 (every rank
shrinks the box the same way, from the gathered mask), and a bursting_gene
solve whose drops open only under memory pressure (measured against the
whole box).

The rank function lives at module level (spawned processes import it);
this module imports no JAX, so the ranks never load it."""

import numpy as np
import pytest
import torch

from krylovfspssa_tpu_torch import SolverConfig, load_model, solve_cme_box
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.parallel.multihost import spawn

torch.set_num_threads(2)

#: the spawn: its ranks run one thread each and must be done within this
#: (about a minute alone; the limit leaves room for a loaded machine)
SPAWN = dict(backend="gloo", timeout_s=300, threads=1)

#: drops open only under memory pressure (the leak-rate gate is shut); on
#: bursting_gene t=20 the one-device solve drops 3 times at a pressure
#: fraction of 1/4 of the box and 4 times at 1/8, which is what a rank
#: would see if it measured the pressure against its own half of the cells
PRESSURE = dict(drop_rate_frac=0.0, drop_pressure_frac=0.25)


def _cases():
    """name -> (model, t, x0, fsp_tol, krylov_tol, config)."""
    import _birth_death

    bd = load_model(_birth_death.PATH)
    bd.reset_parameters(_birth_death.PARAMS)
    c = _birth_death.CASE
    return {
        "toggle": (tlib.toggle_file_model(), 5.0, [[0, 0]], 1e-4, 1e-8,
                   SolverConfig()),
        "birth_death": (bd, c["t"], c["x0"], c["fsp_tol"], c["krylov_tol"],
                        SolverConfig(max_steps_per_call=5)),
        "pressure": (tlib.bursting_gene_model(), 20.0, [[0, 0]], 1e-5, 1e-10,
                     SolverConfig(**PRESSURE)),
    }


def _solve(case, **kw):
    model, t, x0, fsp_tol, krylov_tol, config = case
    return solve_cme_box(model, t, x0, fsp_tol=fsp_tol,
                         krylov_tol=krylov_tol, config=config, **kw)


def _fused_rank(mesh):
    """Every case on this rank's rows (the default, fused loop)."""
    out = {}
    for name, case in _cases().items():
        res = _solve(case, mesh=mesh)
        out[name] = (res, list(res.stats.records))
    return out


@pytest.fixture(scope="module")
def fused():
    ranks = spawn(_fused_rank, ["cpu", "cpu"], **SPAWN)
    one = {name: _solve(case, device="cpu")
           for name, case in _cases().items()}
    return ranks, one


@pytest.mark.parametrize("name", ["toggle", "birth_death", "pressure"])
def test_two_rank_fused_solve_matches_one_device(fused, name):
    """Equal records on every rank, the one-device fused solve's box and
    L1 <= 2 * fsp_tol to it.  (Sums over ranks round differently in the
    last bits, and the step controller can fork on that, as it does
    between the packages: toggle's 18th step picks m = 98 on two ranks
    and 100 on one device.)"""
    ranks, one = fused
    (r0, rec0), (r1, rec1) = ranks[0][name], ranks[1][name]
    ref = one[name]
    print(f"{name}: 2 ranks nstep {r0.stats.nstep} nmult {r0.stats.nmult}, "
          f"one device nstep {ref.stats.nstep} nmult {ref.stats.nmult}")
    assert len(rec0) >= r0.stats.nstep > 0
    assert rec0 == rec1
    assert np.array_equal(r0.w_flat, r1.w_flat)
    assert r0.box.shape == ref.box.shape
    assert r0.stats.iflag == 0
    fsp_tol = _cases()[name][3]
    assert r0.wsum >= 1.0 - fsp_tol
    pa = {tuple(s): p for s, p in zip(r0.states, r0.probabilities)}
    pb = {tuple(s): p for s, p in zip(ref.states, ref.probabilities)}
    l1 = sum(abs(pa.get(k, 0.0) - pb.get(k, 0.0)) for k in set(pa) | set(pb))
    assert l1 <= 2 * fsp_tol


def test_fused_budget_shrinks_on_every_rank(fused):
    ranks, _ = fused
    for out in ranks:
        res, _ = out["birth_death"]
        assert res.box.shape == (64,) and res.stats.nstep == 58


def test_drop_pressure_counts_the_whole_box(fused):
    """Under a mesh the drop's memory-pressure escape compares the active
    cells with the whole box's volume, not a rank's rows: the 2-rank solve
    drops as the one-device solve does (3 times), not as a solve at half
    the pressure fraction (4 times)."""
    ranks, one = fused
    model, t, x0, fsp_tol, krylov_tol, _ = _cases()["pressure"]
    half = solve_cme_box(
        model, t, x0, fsp_tol=fsp_tol, krylov_tol=krylov_tol,
        config=SolverConfig(**dict(PRESSURE, drop_pressure_frac=0.125)),
        device="cpu")
    assert one["pressure"].stats.n_drops == 3
    assert half.stats.n_drops == 4
    for out in ranks:
        assert out["pressure"][0].stats.n_drops == 3
