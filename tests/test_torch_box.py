"""PyTorch port vs JAX package: BoxSpace geometry (axis order, log2,
offsets), flat_index/species_counts, grow/shrink/embed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovfspssa_tpu.boxspace.box import BoxSpace as JBox
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu_torch.boxspace.box import BoxSpace as TBox

torch.set_num_threads(2)

CASES = [
    ("toggle", [[0, 0]]),
    ("goutsias", [[2, 6, 0, 2, 0, 0]]),
    ("repressilator", [[0, 0, 0]]),
]


def _boxes(name, x0):
    stoich = jlib.get_model(name).stoichiometry
    return JBox.for_model(stoich, x0), TBox.for_model(stoich, x0)


def _same_geometry(jb, tb):
    assert tb.axis_of_species == jb.axis_of_species
    assert tb.log2 == jb.log2
    assert tb.shape == jb.shape and tb.volume == jb.volume
    for attr in ("strides", "shift_of_species", "bits_of_species",
                 "extents", "offsets"):
        np.testing.assert_array_equal(getattr(tb, attr), getattr(jb, attr))


@pytest.mark.parametrize("name,x0", CASES)
def test_geometry_matches_jax(name, x0):
    jb, tb = _boxes(name, x0)
    _same_geometry(jb, tb)
    for s in range(jb.n_species):
        _same_geometry(jb.grow(s), tb.grow(s))
        _same_geometry(jb.grow(s).grow(s).shrink(s), tb.grow(s))


@pytest.mark.parametrize("name,x0", CASES)
def test_flat_index_roundtrip_matches_jax(name, x0):
    jb, tb = _boxes(name, x0)
    rng = np.random.default_rng(0)
    states = np.stack(
        [rng.integers(-1, e + 1, size=200) for e in jb.extents], axis=1
    )
    ref = np.asarray(jb.flat_index(states))
    got = tb.flat_index(states)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    inside = ref >= 0
    assert inside.any() and (~inside).any()
    back = torch.stack(
        tb.species_counts(got[torch.from_numpy(inside)], torch.int64), dim=1
    ).numpy()
    np.testing.assert_array_equal(back, states[inside])
    jback = np.asarray(jnp.stack(
        jb.species_counts(jnp.asarray(ref[inside]), jnp.int64), axis=1
    ))
    np.testing.assert_array_equal(back, jback)


@pytest.mark.parametrize("name,x0", CASES)
def test_grow_shrink_embed_match_jax(name, x0):
    jb, tb = _boxes(name, x0)
    rng = np.random.default_rng(1)
    for s in range(jb.n_species):
        arr = rng.random(jb.volume)
        jg, tg = jb.grow(s), tb.grow(s)
        grown = tg.embed(tb, torch.from_numpy(arr), fill=0.0)
        np.testing.assert_array_equal(
            grown.numpy(), np.asarray(jg.embed(jb, jnp.asarray(arr), 0.0))
        )
        back = tb.embed(tg, grown, fill=0.0)
        np.testing.assert_array_equal(back.numpy(), arr)
        mask = rng.random(jg.volume) < 0.5
        np.testing.assert_array_equal(
            tb.embed(tg, torch.from_numpy(mask), fill=False).numpy(),
            np.asarray(jb.embed(jg, jnp.asarray(mask), fill=False)),
        )
