"""PyTorch port vs JAX package: expressions, model loader, propensities and
propensity factorization (same inputs, made with numpy from a seed)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovfspssa_tpu.models import expressions as jexpr
from krylovfspssa_tpu.models import factorize as jfac
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu.models.model import ModelError as JModelError
from krylovfspssa_tpu.models.model import load_model as jload
from krylovfspssa_tpu_torch.models import expressions as texpr
from krylovfspssa_tpu_torch.models import factorize as tfac
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.models.model import ModelError as TModelError
from krylovfspssa_tpu_torch.models.model import load_model as tload

torch.set_num_threads(2)

MODELS_DIR = Path(__file__).resolve().parent.parent / "models"
EXPRESSION_MODELS = ["toggle", "toggle_parser", "repressilator", "goutsias",
                     "bursting_gene"]


@pytest.mark.parametrize("name", EXPRESSION_MODELS)
def test_propensities_match_jax(name):
    """256 random states: propensities agree to rtol 1e-12."""
    jm, tm = jlib.get_model(name), tlib.get_model(name)
    rng = np.random.default_rng(0)
    states = rng.integers(0, 60, size=(256, jm.n_species))
    ref = np.asarray(jm.propensities(jnp.asarray(states)))
    got = tm.propensities(states).numpy()
    assert got.dtype == np.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", EXPRESSION_MODELS)
def test_factor_tables_match_jax(name):
    """Same factorization (constants) and the same factor tables, plain
    and shifted, over a 64-wide coordinate range.  Integer powers and
    +-*/ are correctly rounded in both evaluators; non-integer powers go
    through each library's pow, hence rtol 1e-15 instead of equality."""
    jm, tm = jlib.get_model(name), tlib.get_model(name)
    jf, tf = jfac.factorize_model(jm), tfac.factorize_model(tm)
    assert jf is not None and tf is not None
    for k, (a, b) in enumerate(zip(jf, tf)):
        assert a.const == b.const
        assert sorted(a.factors) == sorted(b.factors)
        for s in range(jm.n_species):
            nu = int(jm.stoichiometry[k, s])
            np.testing.assert_allclose(
                tfac.factor_table(b, s, 64, tm),
                jfac.factor_table(a, s, 64, jm), rtol=1e-15, atol=0,
            )
            np.testing.assert_allclose(
                tfac.shifted_factor_table(b, s, 64, nu, tm),
                jfac.shifted_factor_table(a, s, 64, nu, jm),
                rtol=1e-15, atol=0,
            )


@pytest.mark.parametrize(
    "path", sorted(MODELS_DIR.glob("*.input")), ids=lambda p: p.stem
)
def test_input_loader_matches_jax(path):
    """Same stoichiometry, names and expressions (or the same refusal)."""
    try:
        jm = jload(path)
    except JModelError as e:
        with pytest.raises(TModelError, match=str(e)[:30]):
            tload(path)
        return
    tm = tload(path)
    np.testing.assert_array_equal(tm.stoichiometry, jm.stoichiometry)
    np.testing.assert_array_equal(tm.parameters, jm.parameters)
    assert tm.species_names == jm.species_names
    assert tm.parameter_names == jm.parameter_names
    assert tm.propensity_expressions == jm.propensity_expressions


@pytest.mark.parametrize("func", jexpr.FUNCTIONS)
def test_function_table_matches_jax(func):
    """Each of the 14 functions on random arguments (domain errors give
    the same inf/nan in both)."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-3, 3, 40), [0.0, 1.0, -1.0]])
    expr = f"{func}(x) + 2*x^2 - x^0.5"
    ref = np.asarray(
        jexpr.compile_expression(expr, ["x"])({"x": jnp.asarray(x)})
    )
    got = texpr.compile_expression(expr, ["x"])(
        {"x": torch.from_numpy(x)}
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=0, equal_nan=True)


def test_expression_semantics():
    ev = lambda e, **env: float(texpr.compile_expression(e, list(env))(  # noqa
        {k: torch.tensor(v, dtype=torch.float64) for k, v in env.items()}))
    assert ev("2^3^2") == 512.0
    assert ev("-2^2") == -4.0
    assert ev("1.5D-3") == 1.5e-3
    assert ev("c7*DNA.D*D", **{"DNA.D": 3.0, "D": 2.0, "c7": 0.5}) == 3.0
    assert np.isinf(ev("1/x", x=0.0))
    assert np.isnan(ev("log(x)", x=-1.0))
    with pytest.raises(texpr.ExpressionError):
        texpr.parse_expression("foo(2)", [])


CUSTOM_MODELS = ["toggle_programmatic", "ge5d"]


@pytest.mark.parametrize("name", CUSTOM_MODELS)
def test_custom_propensities_match_jax(name):
    """The torch callables against the JAX ones on 256 random states
    (rtol 1e-12, equal parameter vectors, names and stoichiometry)."""
    jm, tm = jlib.get_model(name), tlib.get_model(name)
    assert tm.custom_propensity is not None and tm.name == jm.name
    np.testing.assert_array_equal(tm.parameters, jm.parameters)
    np.testing.assert_array_equal(tm.stoichiometry, jm.stoichiometry)
    assert tm.species_names == jm.species_names
    assert tm.parameter_names == jm.parameter_names
    rng = np.random.default_rng(0)
    states = rng.integers(0, 60, size=(256, jm.n_species))
    ref = np.asarray(jm.propensities(jnp.asarray(states)))
    got = tm.propensities(states).numpy()
    assert got.dtype == np.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", CUSTOM_MODELS)
def test_custom_propensity_any_batch_shape(name):
    """The callable indexes with ``...``: a (B, 128, d) batch gives the
    flat (n, d) answer, on a float64 tensor of the states' device."""
    tm = tlib.get_model(name)
    states = torch.from_numpy(np.random.default_rng(4).integers(
        0, 40, size=(2 * 128, tm.n_species)).astype(np.float64))
    params = torch.as_tensor(tm.parameters, dtype=torch.float64)
    flat = tm.propensities(states)
    for k in range(tm.n_reactions):
        blocked = tm.custom_propensity(states.reshape(2, 128, -1), k, params)
        np.testing.assert_array_equal(
            torch.as_tensor(blocked).broadcast_to((2, 128)).reshape(-1),
            flat[:, k])


def test_ge5d_library_matches_input_file():
    """The library's custom ge5d against models/ge5d_model.input with the
    library's parameters (mirror of tests/test_model_loader.py)."""
    mf = tload(MODELS_DIR / "ge5d_model.input")
    mp = tlib.ge5d_model()
    mf.reset_parameters(mp.parameters)
    states = np.array(
        [[0, 0, 0, 0, 0], [1, 2, 3, 4, 5], [3, 1, 0, 2, 1], [2, 5, 5, 5, 5]]
    )
    np.testing.assert_allclose(
        mf.propensities(states).numpy(), mp.propensities(states).numpy(),
        rtol=1e-12, atol=1e-12,
    )
    np.testing.assert_array_equal(mf.stoichiometry, mp.stoichiometry)
