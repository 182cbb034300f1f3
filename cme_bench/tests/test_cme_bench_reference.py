"""CPU tests of the plain reference (cme_bench/reference/) and of the
comparison that decides ``correct``: the reference against closed forms
and against the program's model, the program's CPU solves through both
entries within the cells' limits, and a float32 answer failing them.

    python -m pytest cme_bench/tests -q
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cme_bench import harness  # noqa: E402
from cme_bench.reference import fsp  # noqa: E402

TOGGLE = "toggle-customprop.box-t100"
GOUTSIAS = "goutsias6.table-t30"
GOUTSIAS_BOX = "goutsias6.box-t10"


def _birth_death():
    return fsp.Network(np.array([[1], [-1]]),
                       lambda s, p: np.stack([np.full(len(s), p[0]),
                                              p[1] * s[:, 0]], axis=1))


def test_uniformization_against_the_closed_form():
    # 0 -> X at k, X -> 0 at g*X from X=0: Poisson(k/g (1 - e^{-g t}))
    k, g, t = 20.0, 0.7, 3.0
    sol = fsp.solve(_birth_death(), [0], t, [[k, g]], [64])
    mean = k / g * (1 - math.exp(-g * t))
    n = sol.states[:, 0]
    exact = np.exp(-mean + n * math.log(mean)
                   - np.array([math.lgamma(x + 1.0) for x in n]))
    assert sol.leak.sum() <= 1e-12
    np.testing.assert_allclose(sol.p[0], exact, rtol=1e-10, atol=1e-25)


def test_leaking_bounds_grow():
    sol = fsp.solve(_birth_death(), [0], 3.0, [[20.0, 0.7], [25.0, 0.7]],
                    [8])
    assert sol.bounds[0] >= 64
    assert sol.leak.sum(axis=1).max() <= 1e-12
    assert np.all(np.abs(sol.p.sum(axis=1) - 1) < 1e-12)


def test_reachable_keeps_to_the_bounds_and_conservation():
    ref = harness.load_module("reference", "goutsias6")
    states = fsp.reachable(ref.STOICHIOMETRY, [2, 6, 0, 2, 0, 0],
                           (8, 8, 4, 3, 3, 3))
    assert np.all(states[:, 3:].sum(axis=1) == 2)  # the two gene copies
    assert np.all(states.max(axis=0) < [8, 8, 4, 3, 3, 3])
    sol = fsp.Solution(states, fsp._keys(states, np.array([8, 8, 4, 3, 3, 3])),
                       np.array([8, 8, 4, 3, 3, 3]), None, None)
    assert np.array_equal(sol.lookup(states), np.arange(len(states)))
    assert sol.lookup([[9, 0, 0, 2, 0, 0], [0, 0, 0, 1, 0, 0]]).tolist() \
        == [-1, -1]


@pytest.mark.parametrize("name", [TOGGLE, GOUTSIAS])
def test_reference_network_is_the_configuration(name):
    c = harness.cell(name)
    np.testing.assert_array_equal(c.reference.STOICHIOMETRY,
                                  c.config.STOICHIOMETRY)
    model = c.config.model()
    np.testing.assert_array_equal(model.stoichiometry,
                                  c.config.STOICHIOMETRY)
    rng = np.random.default_rng(3)
    states = rng.integers(0, 40, size=(500, len(c.config.X0)))
    params, _ = harness.parameters(c, 5, 1)
    got = c.reference.propensities(states.astype(np.float64), params)
    want = model.propensities(torch.from_numpy(states), params).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


def _short(name, t, entry=None):
    c = harness.cell(name)
    traffic = dict(c.traffic, t_out=t)
    if entry:
        traffic["entry"] = entry
    return dataclasses.replace(c, traffic=traffic)


def _judge(c, seed, n, dtype=None):
    model = c.config.model()
    solves = [harness.run_solve(c, model, seed, i, "cpu", dtype)
              for i in range(1, n + 1)]
    assert not [sv.fault for sv in solves if sv.fault]
    return max(harness.excesses(
        c, [sv.params for sv in solves],
        [(sv.states, sv.probabilities) for sv in solves], "cpu"))


# the program's CPU solves through both entries, at short horizons, within
# the limits of the cell of their configuration
@pytest.mark.parametrize("name,t,entry", [
    (TOGGLE, 3.0, "box"), (TOGGLE, 3.0, "table"),
    (GOUTSIAS, 5.0, "table"), (GOUTSIAS, 2.0, "box"),
    (GOUTSIAS_BOX, 2.0, "box")])
def test_program_within_the_limits(name, t, entry):
    c = _short(name, t, entry)
    assert _judge(c, 2 ** 31 + 5, 2) <= c.limits["limits"]["excess"]


# the control of every cell: the reference computed in float32, over the 8
# draws a run compares, at horizons the CPU holds in about two minutes
@pytest.mark.parametrize("name,t", [(TOGGLE, 3.0), (GOUTSIAS, 10.0),
                                    (GOUTSIAS_BOX, 10.0)])
def test_float32_reference_in_the_programs_place_fails(name, t):
    c = _short(name, t)
    params = [harness.parameters(c, 9, i)[0] for i in range(1, 9)]
    sol = harness.reference(c, params, "cpu", torch.float32)
    got = harness.excesses(c, params, [(sol.states, sol.p[k])
                                       for k in range(len(params))], "cpu")
    assert max(got) > c.limits["limits"]["excess"]


def test_programs_float32_path_refuses_goutsias():
    c = _short(GOUTSIAS, 5.0)
    sv = harness.run_solve(c, c.config.model(), 3, 1, "cpu", "float32")
    assert sv.fault and "float32" in sv.fault
