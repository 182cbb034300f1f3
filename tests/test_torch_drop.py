"""PyTorch port vs JAX package: the drop mask (24-level threshold ladder
with the inflow guard) and the anti-thrash gate's gross loss rate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovfspssa_tpu.statespace import drop as jdrop
from krylovfspssa_tpu_torch.statespace import drop as tdrop

torch.set_num_threads(2)


def _inputs(seed, n=4096):
    """Probabilities spread over 1e-2..1e-34 (plus exact zeros), a signed
    inflow around the guard, and a random active mask."""
    rng = np.random.default_rng(seed)
    w = 10.0 ** rng.uniform(-34, -2, n)
    w[rng.random(n) < 0.1] = 0.0
    inflow = rng.normal(scale=2e-8, size=n)
    active = rng.random(n) < 0.8
    diag = rng.uniform(0.0, 50.0, n)
    return w, inflow, active, diag


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dsum", [1e-30, 3e-12, 1e-9, 5e-7, 1e-3, 0.0])
def test_drop_mask_matches_jax(seed, dsum):
    w, inflow, active, _ = _inputs(seed)
    jm, jc, jt = jdrop.drop_mask_device(
        jnp.asarray(w), jnp.asarray(inflow), jnp.asarray(active),
        jnp.asarray(dsum))
    tm, tc, tt = tdrop.drop_mask_device(
        torch.from_numpy(w), torch.from_numpy(inflow),
        torch.from_numpy(active), dsum)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tc == int(jc)
    assert tt == pytest.approx(float(jt), rel=1e-15)


@pytest.mark.parametrize("droptol_start,inflow_guard",
                         [(1e-6, 1e-8), (1e-10, 1e-9)])
def test_drop_mask_options_match_jax(droptol_start, inflow_guard):
    w, inflow, active, _ = _inputs(7)
    kw = dict(droptol_start=droptol_start, inflow_guard=inflow_guard)
    jm, jc, _ = jdrop.drop_mask_device(
        jnp.asarray(w), jnp.asarray(inflow), jnp.asarray(active),
        jnp.asarray(1e-8), **kw)
    tm, tc, _ = tdrop.drop_mask_device(
        torch.from_numpy(w), torch.from_numpy(inflow),
        torch.from_numpy(active), 1e-8, **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tc == int(jc)


@pytest.mark.parametrize("seed", [0, 3])
def test_drop_loss_rate_matches_jax(seed):
    w, inflow, active, diag = _inputs(seed)
    dmask = active & (np.random.default_rng(seed + 9).random(w.size) < 0.3)
    ref = float(jdrop.drop_loss_rate(jnp.asarray(w), jnp.asarray(inflow),
                                     jnp.asarray(diag), jnp.asarray(dmask)))
    got = tdrop.drop_loss_rate(torch.from_numpy(w), torch.from_numpy(inflow),
                               torch.from_numpy(diag), torch.from_numpy(dmask))
    assert got == pytest.approx(ref, rel=1e-12)
