"""The table backend's main loops in the PyTorch port against the JAX
package, step for step, on the CPU.

Both packages' ``ssa_extend`` are stubbed with the same identity function
(no state is added by SSA walks; ``ssa_max_steps=0`` crashes in the JAX
package), so an expansion is the deterministic 1-step round, and both
loops of both packages walk the same trajectory:

  * toggle t=5 (TestSolverFromFile's model, fsp_tol 1e-4): every step
    record equal in every integer field and within 1e-12 relative in
    t_step, t_new, t_now and wsum; err_loc within 0.1 x krylov_tol;
  * bursting_gene t=20 (fsp_tol 1e-5): the same through the first 20
    records.  At record 20 both packages' step controllers round an
    err_loc of 7e-13 — round-off size — to a next step of 3.6 or 3.7,
    and the trajectories fork (the JAX package's own two loops fork there
    too, the other way round; ROADMAP.md Queue C).  The solves stay
    within 2 x fsp_tol of each other.
"""

import numpy as np
import pytest
import torch

import krylovfspssa_tpu.solver as jsolver
import krylovfspssa_tpu_torch.solver as tsolver
from krylovfspssa_tpu.config import SolverConfig as JConfig
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu_torch import SolverConfig
from krylovfspssa_tpu_torch.models import library as tlib

torch.set_num_threads(2)

RECORD_INTS = ("nstep", "fsp_size", "m", "advanced", "expanded", "dropped")
RECORD_FLOATS = ("t_step", "t_new", "t_now", "wsum")
KRYLOV_TOL = 1e-10

#: model, t, fsp_tol, records that must agree (None: all of them)
CASES = {
    "toggle": ("toggle_file_model", 5.0, 1e-4, None),
    "bursting": ("bursting_gene_model", 20.0, 1e-5, 20),
}


def _identity(table, *args, **kwargs):
    return table, 0


def _l1(a, b):
    pa = {tuple(s): p for s, p in zip(a.states, a.probabilities)}
    pb = {tuple(s): p for s, p in zip(b.states, b.probabilities)}
    return sum(abs(pa.get(k, 0.0) - pb.get(k, 0.0)) for k in set(pa) | set(pb))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loops_match_jax_with_ssa_stubbed(case, fused, monkeypatch):
    monkeypatch.setattr(jsolver, "ssa_extend", _identity)
    monkeypatch.setattr(tsolver, "ssa_extend", _identity)
    model, t, fsp_tol, agree = CASES[case]
    kw = dict(fsp_tol=fsp_tol, krylov_tol=KRYLOV_TOL)
    want = jsolver.solve_cme(getattr(jlib, model)(), t, [[0, 0]],
                             config=JConfig(fused_steps=fused), **kw)
    got = tsolver.solve_cme(getattr(tlib, model)(), t, [[0, 0]],
                            config=SolverConfig(fused_steps=fused),
                            device="cpu", **kw)
    a, b = want.stats.records, got.stats.records
    assert got.stats.n_expansions > 10
    if agree is None:
        assert len(a) == len(b)
        assert (got.stats.nstep, got.stats.nmult, got.stats.n_drops) == (
            want.stats.nstep, want.stats.nmult, want.stats.n_drops)
        np.testing.assert_array_equal(got.states, want.states)
        np.testing.assert_allclose(got.probabilities, want.probabilities,
                                   rtol=0, atol=1e-12)
    for i, (ra, rb) in enumerate(zip(a, b[:agree])):
        for k in RECORD_INTS:
            assert getattr(ra, k) == getattr(rb, k), (i, k, ra, rb)
        for k in RECORD_FLOATS:
            np.testing.assert_allclose(getattr(rb, k), getattr(ra, k),
                                       rtol=1e-12, err_msg=f"{i} {k}")
        assert abs(ra.err_loc - rb.err_loc) <= 0.1 * KRYLOV_TOL, (i, ra, rb)
    if agree is not None:
        assert len(b) > agree
        assert got.stats.iflag == 0 and got.wsum >= 1 - fsp_tol
        assert _l1(got, want) <= 2 * fsp_tol
