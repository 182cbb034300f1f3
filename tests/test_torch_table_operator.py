"""The table backend's operator in the PyTorch port against the JAX
package, on the CPU: ``build_operator`` on the same state tables (toggle,
the 6-species Goutsias model and the 5-species ge5d model, whose keys
take two int64 words) gives the same ``pred_idx``/``succ_idx``/
``succ_legal``, and diag, props and pred_prop within 1e-14 relative; the
gather-ELL ``spmv`` gives the JAX y within 1e-12; the lexicographic
lookup of multi-word keys matches a brute-force search."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu.ops.operator import build_operator as j_build
from krylovfspssa_tpu.ops.spmv import spmv as j_spmv
from krylovfspssa_tpu.statespace.encoding import StateEncoder as JEncoder
from krylovfspssa_tpu.statespace.expand import onestep_extend as j_onestep
from krylovfspssa_tpu.statespace.table import StateTable as JTable
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.ops import spmv as spmv_mod
from krylovfspssa_tpu_torch.ops.operator import (
    build_operator,
    lookup_keys,
    operator_nnz,
)
from krylovfspssa_tpu_torch.ops.spmv import operator_nreactions, spmv
from krylovfspssa_tpu_torch.statespace.encoding import StateEncoder

torch.set_num_threads(2)

#: (library model, seed state, 1-step rounds): the table grows from the
#: seed; drop a few rows so that some predecessors are outside it
CASES = {
    "toggle": ("toggle_file_model", [0, 0], 12),
    "goutsias": ("goutsias_model", [2, 6, 0, 2, 0, 0], 4),
    "ge5d": ("ge5d_model", [0, 0, 0, 0, 0], 3),
}


def _table(name):
    model_name, x0, rounds = CASES[name]
    jmodel = getattr(jlib, model_name)()
    jenc = JEncoder.for_model(jmodel.n_species, 10_000)
    j = JTable.from_states(np.array([x0], np.int32), jenc, capacity=64)
    for _ in range(rounds):
        j, _ = j_onestep(j, np.asarray(jmodel.stoichiometry), None)
    keep = np.random.default_rng(0).random(j.n) < 0.9
    keep[0] = True
    j, _ = j.compact(keep)
    return jmodel, getattr(tlib, model_name)(), jenc, j


def _ops(name, dtype=torch.float64):
    jmodel, tmodel, jenc, j = _table(name)
    stoich = np.asarray(jmodel.stoichiometry)
    jop = j_build(jnp.asarray(j.states), jnp.asarray(j.sorted_keys),
                  jnp.asarray(j.sorted_to_row), jnp.asarray(j.n, jnp.int32),
                  jmodel.propensities, stoich, jenc)
    enc = StateEncoder.for_model(tmodel.n_species, 10_000)
    op = build_operator(torch.as_tensor(j.states),
                        torch.as_tensor(j.sorted_keys),
                        torch.as_tensor(j.sorted_to_row), j.n,
                        tmodel.propensities, stoich, enc, dtype)
    return jop, op, j


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_operator_matches_jax(name):
    jop, op, j = _ops(name)
    assert j.encoder.n_words == (2 if name != "toggle" else 1)
    for f in ("pred_idx", "succ_idx", "succ_legal"):
        got, want = getattr(op, f).numpy(), np.asarray(getattr(jop, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("diag", "props", "pred_prop"):
        got = getattr(op, f).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jop, f)),
                                   rtol=1e-14, atol=0, err_msg=f)
    assert int(op.n) == j.n and op.n.dtype == torch.int32
    assert np.any(op.pred_idx.numpy()[: j.n] < 0)
    assert np.any(op.pred_idx.numpy()[: j.n] >= 0)
    assert operator_nnz(op) == (op.props.shape[1] + 1) * j.n
    assert operator_nreactions(op) == op.props.shape[1]


@pytest.mark.parametrize("name", sorted(CASES))
def test_spmv_matches_jax(name):
    jop, op, j = _ops(name)
    x = np.zeros(j.capacity)
    x[: j.n] = np.random.default_rng(1).random(j.n)
    before = spmv_mod.CALLS
    y = spmv(op, torch.as_tensor(x))
    assert spmv_mod.CALLS == before + 1
    want = np.asarray(j_spmv(jop, jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    # float32 operator: the same y to float32 rounding
    _, op32, _ = _ops(name, torch.float32)
    y32 = spmv(op32, torch.as_tensor(x, dtype=torch.float32))
    assert y32.dtype == torch.float32
    np.testing.assert_allclose(y32.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_wide_lookup_against_bruteforce():
    enc = StateEncoder.for_model(5, 10_000)
    assert enc.n_words == 2
    rng = np.random.default_rng(2)
    states = np.unique(rng.integers(0, 50, size=(200, 5)).astype(np.int32),
                       axis=0)
    j = JTable.from_states(states, JEncoder.for_model(5, 10_000),
                           capacity=512)
    queries = rng.integers(0, 50, size=(400, 5)).astype(np.int32)
    queries[:50] = states[:50]
    got = lookup_keys(torch.as_tensor(j.sorted_keys),
                      torch.as_tensor(j.sorted_to_row),
                      enc.encode(torch.as_tensor(queries))).numpy()
    lut = {tuple(s): i for i, s in enumerate(states)}
    want = [lut.get(tuple(q), -1) for q in queries]
    np.testing.assert_array_equal(got, want)
    assert np.all(got[:50] >= 0)
