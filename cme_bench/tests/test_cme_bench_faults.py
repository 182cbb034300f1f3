"""A run of each cell with the look for a card skipped (on the CPU, at a
short horizon) and the timed path broken underneath: ``correct`` must
come out false.  The sound run beside them comes out true.

    python -m pytest cme_bench/tests -q
"""

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cme_bench import harness  # noqa: E402

CELLS = {"toggle-customprop.box-t100": 2.0, "goutsias6.table-t30": 4.0,
         "goutsias6.box-t10": 0.5}


def _run(name, seed=2 ** 31 + 17):
    c = harness.cell(name)
    c = dataclasses.replace(c, traffic=dict(c.traffic, t_out=CELLS[name]))
    return harness.run(c, seed, 1.0, False, time.perf_counter(),
                       device="cpu", log=lambda s: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r["checks"]) == ["gate_failures", "excess"]


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_by_each_step(name, monkeypatch):
    from krylovfspssa_tpu_torch.krylov import stepper

    real = stepper.expm_pade

    def identity(H, mx, t, ideg=6):
        E, hnorm, ns = real(H, mx, t, ideg)
        return torch.eye(E.shape[0], dtype=E.dtype, device=E.device), \
            hnorm, ns

    monkeypatch.setattr(stepper, "expm_pade", identity)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_it_is_produced(name, monkeypatch):
    import krylovfspssa_tpu_torch as program

    entry = harness.cell(name).traffic["entry"]
    attr = {"box": "solve_cme_box", "table": "solve_cme"}[entry]
    real = getattr(program, attr)

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        p = res.probabilities  # a thousandth of the top state's mass moved
        moved = 1e-3 * p.max()  # to the least likely state
        p[np.argmax(p)] -= moved
        p[np.argmin(p)] += moved
        return res

    monkeypatch.setattr(program, attr, altered)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_draw_left_out(name, monkeypatch):
    from krylovfspssa_tpu_torch import Model

    real = Model.reset_parameters

    def first_only(self, values):  # every solve at the published rates
        if not getattr(self, "_set_once", False):
            real(self, values)
            self._set_once = True

    monkeypatch.setattr(Model, "reset_parameters", first_only)
    assert not _run(name)["correct"]


def test_programs_float32_path_fails_goutsias(monkeypatch):
    c = harness.cell("goutsias6.table-t30")
    monkeypatch.setattr(c.config, "DTYPE", "float32")
    r = _run("goutsias6.table-t30")
    assert not r["correct"] and r["failed"] == r["attempted"]
