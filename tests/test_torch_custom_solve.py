"""PyTorch port vs JAX package, end to end, for the models whose
propensities do not factor per species (the CUSTOMPROP path): CPU box
solves of ``toggle_programmatic`` and ``ge5d`` in both packages (the JAX
one with its stepwise loop), held to the FSP tolerance contract (L1 <=
2*fsp_tol); the library ge5d (custom callable) against the same model
from ``models/ge5d_model.input`` (separable expressions); and the CLI and
the example drivers."""

from pathlib import Path

import numpy as np
import pytest
import torch

from krylovfspssa_tpu.boxsolver import BoxCmeSolver as JSolver
from krylovfspssa_tpu.config import SolverConfig as JConfig
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu_torch import SolverConfig, load_model, solve_cme_box
from krylovfspssa_tpu_torch.cli import main as cli_main
from krylovfspssa_tpu_torch.examples import goutsias as goutsias_example
from krylovfspssa_tpu_torch.examples import repressilator as repressilator_example
from krylovfspssa_tpu_torch.examples import toggle as toggle_example
from krylovfspssa_tpu_torch.models import library as tlib

torch.set_num_threads(2)

MODELS_DIR = Path(__file__).resolve().parent.parent / "models"

CASES = {
    # the examples/toggle.f90 tolerances over a shorter horizon
    "toggle_programmatic": dict(t=2.0, x0=[[0, 0]], fsp_tol=1e-4,
                                krylov_tol=1e-10, config={}),
    # tests/test_models_e2e.py::test_ge5d_smoke_solve_fast
    "ge5d": dict(t=0.4, x0=[[0, 0, 0, 0, 0]], fsp_tol=1e-4, krylov_tol=1e-8,
                 config=dict(box_min_log2=2)),
}


def _l1(a, b):
    pa = {tuple(s): p for s, p in zip(a.states, a.probabilities)}
    pb = {tuple(s): p for s, p in zip(b.states, b.probabilities)}
    return sum(abs(pa.get(k, 0.0) - pb.get(k, 0.0)) for k in set(pa) | set(pb))


def _port_solve(model, case, **config):
    return solve_cme_box(model, case["t"], case["x0"],
                         fsp_tol=case["fsp_tol"],
                         krylov_tol=case["krylov_tol"],
                         config=SolverConfig(**case["config"], **config),
                         device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_custom_model_solve_matches_jax(name):
    case = CASES[name]
    j = JSolver(jlib.get_model(name),
                JConfig(fused_steps=False, **case["config"])).solve(
        case["t"], case["x0"], fsp_tol=case["fsp_tol"],
        krylov_tol=case["krylov_tol"])
    t = _port_solve(tlib.get_model(name), case, fused_steps=False)
    print(f"{name}: jax nstep {j.stats.nstep} nmult {j.stats.nmult} box "
          f"{j.box.volume} | port nstep {t.stats.nstep} nmult "
          f"{t.stats.nmult} box {t.box.volume}")
    assert t.stats.iflag == 0
    assert np.all(np.isfinite(t.probabilities))
    assert t.wsum >= 1.0 - case["fsp_tol"]
    assert abs(t.wsum - j.wsum) <= case["fsp_tol"]
    assert _l1(j, t) <= 2 * case["fsp_tol"]


def test_ge5d_library_matches_input_file_solve():
    """The custom-callable ge5d (direct form) and the .input ge5d
    (separable, destination form) solve the same CME."""
    case = CASES["ge5d"]
    lib = tlib.ge5d_model()
    inp = load_model(MODELS_DIR / "ge5d_model.input")
    inp.reset_parameters(lib.parameters)
    a, b = _port_solve(lib, case), _port_solve(inp, case)
    assert a.stats.iflag == 0 and b.stats.iflag == 0
    assert min(a.wsum, b.wsum) >= 1.0 - case["fsp_tol"]
    assert _l1(a, b) <= 2 * case["fsp_tol"]


def test_cli_models_lists_all_seven(capsys):
    assert cli_main(["models"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 7
    assert "NOT PORTED" not in out
    for name in tlib.LIBRARY:
        assert any(ln.startswith(name + " ") for ln in lines), name
    assert out.count("custom propensity") == 2


@pytest.mark.parametrize("name,t", [("toggle_programmatic", "0.5"),
                                    ("ge5d", "0.2")])
def test_cli_solve_custom_model_on_cpu(name, t, capsys):
    assert cli_main(["solve", name, "--t", t, "--device", "cpu",
                     "--json"]) == 0
    out = capsys.readouterr().out
    assert f"model          : {name}" in out
    assert "backend        : box (cpu)" in out


@pytest.mark.parametrize("example,t", [(toggle_example, "0.5"),
                                       (repressilator_example, "0.02"),
                                       (goutsias_example, "0.5")],
                         ids=["toggle", "repressilator", "goutsias"])
def test_example_runs_on_cpu(example, t, capsys):
    """Each example driver at a short horizon (goutsias' default t=300
    outgrows max_box_volume, as in the JAX package)."""
    res = example.main(["--t", t, "--device", "cpu"])
    assert res.stats.iflag == 0 and res.wsum >= 1.0 - 1e-4
    assert "final FSP size" in capsys.readouterr().out
