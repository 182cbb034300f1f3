"""The stencil kernels' contract ``supp(x) ⊆ mask`` (csrc/sep_stencil.cuh
reads its sources without the mask, in the separable mode and in
direct_stencil's): the box solver keeps it, on the separable path and on
the custom-propensity one.  A spy wraps every matvec the solver builds — the Arnoldi
matvecs and the drop ladder's inflow — and records, call by call, whether
x is non-zero outside the mask.  CPU solves, one device and 2 gloo ranks
(the rank function lives at module level: spawned processes import it)."""

import pytest
import torch

from krylovfspssa_tpu_torch import boxsolver, solve_cme_box
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.parallel.multihost import spawn

torch.set_num_threads(2)


def _spy(calls):
    """select_stencil_matvec whose matvecs append, per call, whether x is
    non-zero at a cell outside the mask."""
    real = boxsolver.select_stencil_matvec

    def select(*args, **kw):
        mv = real(*args, **kw)

        def matvec(mask, x):
            calls.append(bool(torch.any((x != 0) & ~mask)))
            return mv(mask, x)

        return matvec

    return select


@pytest.mark.parametrize("name,t,x0,fsp_tol", [
    ("toggle", 5.0, [[0, 0]], 1e-4),
    ("goutsias", 1.0, [[2, 6, 0, 2, 0, 0]], 1e-6),
    ("toggle_programmatic", 2.0, [[0, 0]], 1e-4),
])
def test_solver_keeps_x_inside_mask(monkeypatch, name, t, x0, fsp_tol):
    calls = []
    monkeypatch.setattr(boxsolver, "select_stencil_matvec", _spy(calls))
    res = solve_cme_box(tlib.get_model(name), t, x0, fsp_tol=fsp_tol,
                        krylov_tol=1e-8, device="cpu")
    assert res.stats.iflag == 0
    assert len(calls) >= res.stats.nmult > 0
    assert not any(calls)


def _spy_rank(mesh):
    calls = []
    boxsolver.select_stencil_matvec = _spy(calls)
    res = solve_cme_box(tlib.bursting_gene_model(), 5.0, [[0, 0]],
                        fsp_tol=1e-4, krylov_tol=1e-8, mesh=mesh)
    return res.stats.nmult, res.stats.n_drops, calls


def test_sharded_solver_keeps_x_inside_mask():
    """2 gloo ranks, bursting gene t=5 (growth, drops, dilation rounds):
    every call on every rank meets the contract on its rows."""
    for nmult, _, calls in spawn(_spy_rank, ["cpu", "cpu"], backend="gloo",
                                 timeout_s=120, threads=1):
        assert len(calls) >= nmult > 0
        assert not any(calls)
