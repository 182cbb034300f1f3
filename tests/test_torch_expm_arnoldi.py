"""PyTorch port vs JAX package: the small-Hessenberg exponential, one
Arnoldi factorization, and one adaptive step from the same StepCarry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovfspssa_tpu.boxspace.box import BoxSpace as JBox
from krylovfspssa_tpu.config import SolverConfig as JConfig
from krylovfspssa_tpu.krylov import arnoldi as jarn
from krylovfspssa_tpu.krylov import stepper as jstep
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu.ops import expm as jexpm
from krylovfspssa_tpu.ops import stencil as jst
from krylovfspssa_tpu_torch.boxspace.box import BoxSpace as TBox
from krylovfspssa_tpu_torch.checkpoint import carry_from_numpy
from krylovfspssa_tpu_torch.config import SolverConfig
from krylovfspssa_tpu_torch.krylov import arnoldi as tarn
from krylovfspssa_tpu_torch.krylov import stepper as tstep
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.ops import expm as texpm
from krylovfspssa_tpu_torch.ops import stencil as tst

torch.set_num_threads(2)


def _hessenberg(rng, MH, mx, scale):
    """Random stable upper-Hessenberg block (negative diagonal, CME-like)
    in an (MH, MH) workspace with garbage outside the leading block."""
    H = rng.normal(size=(MH, MH))
    H[:mx, :mx] = np.triu(rng.random((mx, mx)), -1) * scale
    H[np.arange(mx), np.arange(mx)] = -scale * (1 + rng.random(mx))
    return H


@pytest.mark.parametrize(
    "mx,t,scale", [(12, 0.7, 1.0), (30, -2.5, 40.0), (52, 1e-3, 5.0),
                   (8, 30.0, 300.0), (3, 0.0, 1.0)]
)
def test_expm_pade_matches_jax(mx, t, scale):
    rng = np.random.default_rng(mx)
    MH = 54
    H = _hessenberg(rng, MH, mx, scale)
    Ej, hj, nsj = jexpm.expm_pade(jnp.asarray(H), jnp.asarray(mx),
                                  jnp.asarray(t), 6)
    Et, ht, nst = texpm.expm_pade(torch.from_numpy(H), mx, t, 6)
    assert nst == int(nsj)
    assert ht == pytest.approx(float(hj), rel=1e-14)
    Ej = np.asarray(Ej)
    np.testing.assert_allclose(Et.numpy(), Ej, rtol=0,
                               atol=1e-12 * np.abs(Ej).max())


@pytest.mark.parametrize("mx,t,scale", [(10, 0.5, 1.0), (25, 3.0, 10.0)])
def test_expm_chebyshev_matches_jax(mx, t, scale):
    rng = np.random.default_rng(100 + mx)
    MH = 32
    H = _hessenberg(rng, MH, mx, scale)
    Ej, hj, _ = jexpm.expm_chebyshev_col0(jnp.asarray(H), jnp.asarray(mx),
                                          jnp.asarray(t))
    Et, ht, nst = texpm.expm_chebyshev_col0(torch.from_numpy(H), mx, t)
    assert nst == 0 and ht == pytest.approx(float(hj), rel=1e-14)
    Ej = np.asarray(Ej)
    np.testing.assert_allclose(Et.numpy(), Ej, rtol=0,
                               atol=1e-12 * np.abs(Ej).max())


def _toggle(extent=32, dilations=10):
    """A toggle box with a dilated mask and a masked random vector (same
    numpy inputs for both packages)."""
    jm, tm = jlib.toggle_file_model(), tlib.toggle_file_model()
    jb = JBox.for_model(jm.stoichiometry, [[0, 0]], min_log2=2)
    tb = TBox.for_model(tm.stoichiometry, [[0, 0]], min_log2=2)
    for s in range(2):
        while jb.extents[s] < extent:
            jb, tb = jb.grow(s), tb.grow(s)
    mask = np.zeros(jb.volume, bool)
    mask[int(np.asarray(jb.flat_index(np.array([[0, 0]])))[0])] = True
    m = jnp.asarray(mask)
    for _ in range(dilations):
        m = jst.dilate_mask(jb, m)
    return jm, tm, jb, tb, np.array(m)


def test_arnoldi_extend_matches_jax():
    """Arnoldi to m=6 from jold=1, then resumed to m=11 from jold=6, from
    the same V/H in both packages: H and V to 1e-12."""
    jm, tm, jb, tb, mask = _toggle()
    rng = np.random.default_rng(5)
    w = np.where(mask, rng.random(jb.volume), 0.0)
    MH = 14
    V0 = np.zeros((MH, jb.volume))
    V0[0] = w / np.linalg.norm(w)
    H0 = np.zeros((MH, MH))
    jmv = jst.make_stencil_matvec(jm, jb)
    tmv = tst.make_stencil_matvec(tm, tb)
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    V, H = V0, H0
    for jold, m in ((1, 6), (6, 11)):
        js = jarn.arnoldi_extend(
            lambda x: jmv(jmask, x), jnp.asarray(V), jnp.asarray(H),
            jnp.asarray(jold), jnp.asarray(m), 2, 1e-7)
        ts = tarn.arnoldi_extend(
            lambda x: tmv(tmask, x), torch.from_numpy(V.copy()),
            torch.from_numpy(H.copy()), jold, m, 2, 1e-7)
        Hj, Vj = np.asarray(js.H), np.asarray(js.V)
        np.testing.assert_allclose(ts.H.numpy(), Hj, rtol=0,
                                   atol=1e-12 * np.abs(Hj).max())
        np.testing.assert_allclose(ts.V.numpy(), Vj, rtol=0, atol=1e-12)
        assert ts.breakdown == bool(js.breakdown)
        assert ts.mbrkdwn == int(js.mbrkdwn)
        assert ts.nmult == int(js.nmult)
        assert ts.avnorm == pytest.approx(float(js.avnorm), rel=1e-12)
        V, H = Vj, Hj


def test_dot64_blocked_float32():
    rng = np.random.default_rng(9)
    a, b = rng.random(4096).astype(np.float32), rng.random(4096).astype(
        np.float32)
    got = tarn.dot64(torch.from_numpy(a), torch.from_numpy(b))
    ref = jarn.dot64(jnp.asarray(a), jnp.asarray(b))
    exact = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    assert got.dtype == torch.float64
    # f32 products summed in f32 only within 128-wide blocks (in another
    # order than XLA's), then in f64: both within ~eps32 of the exact dot
    assert float(got) == pytest.approx(exact, rel=1e-6)
    assert float(got) == pytest.approx(float(ref), rel=1e-6)


def _step_fns(jm, tm, jb, tb, jcfg, tcfg, dtype_j, dtype_t):
    jmv = jst.make_stencil_matvec(jm, jb, dtype_j)
    jdiag = jst.make_diag_fn(jm, jb)
    R = jm.n_reactions
    jfn = jax.jit(jstep.make_step_fn(
        lambda m: (lambda x: jmv(m, x)), jcfg,
        op_info=lambda m: (jnp.sum(m).astype(jnp.int32), R,
                           2.0 * jnp.max(jnp.where(m, jdiag(m), 0.0)))))
    tmv = tst.make_stencil_matvec(tm, tb, dtype_t)
    tdiag = tst.make_diag_fn(tm, tb)

    def info(m):
        return int(m.sum()), R, 2.0 * float(torch.max(tdiag(m)))

    tfn = tstep.make_step_fn(lambda m: (lambda x: tmv(m, x)), tcfg, info)
    return jfn, tfn


def _carry_np(carry):
    return {k: np.asarray(v) for k, v in carry._asdict().items()}


def _compare_step(jfn, tfn, mask, w, carry_np, t_out, fsptol, krytol,
                  t_rtol=1e-10, w_tol=1e-12):
    jr = jfn(jnp.asarray(mask), jnp.asarray(w), jstep.StepCarry(
        **{k: jnp.asarray(v) for k, v in carry_np.items()}),
        jnp.asarray(t_out), jnp.asarray(fsptol), jnp.asarray(krytol))
    tr = tfn(torch.from_numpy(mask), torch.from_numpy(np.array(w)),
             carry_from_numpy(carry_np), t_out, fsptol, krytol)
    assert tr.advanced == bool(jr.advanced)
    assert tr.iexpand == bool(jr.iexpand)
    assert tr.m_used == int(jr.m_used)
    assert tr.t_step == pytest.approx(float(jr.t_step), rel=t_rtol)
    assert int(tr.carry.iflag) == int(jr.carry.iflag)
    assert int(tr.carry.nstep) == int(jr.carry.nstep)
    assert float(tr.carry.t_now) == pytest.approx(float(jr.carry.t_now),
                                                  rel=t_rtol)
    wj = np.asarray(jr.w, np.float64)
    np.testing.assert_allclose(tr.w.double().numpy(), wj, rtol=0,
                               atol=w_tol * np.abs(wj).max())
    return jr, tr


def test_step_from_same_carry_matches_jax():
    """Three JAX steps make a mid-solve carry (with order/kfactor history);
    one step from it in both packages gives the same outcome."""
    jm, tm, jb, tb, mask = _toggle(extent=64, dilations=16)
    cfg = dict(m_max=40)
    jfn, tfn = _step_fns(jm, tm, jb, tb, JConfig(**cfg), SolverConfig(**cfg),
                         jnp.float64, torch.float64)
    w = np.zeros(jb.volume)
    w[int(np.asarray(jb.flat_index(np.array([[0, 0]])))[0])] = 1.0
    t_out, fsptol, krytol = 5.0, 1e-4, 1e-8
    carry = jstep.initial_carry(1.0, t_out, krytol, 1.0, 10)
    wj = jnp.asarray(w)
    for _ in range(3):
        jr = jfn(jnp.asarray(mask), wj, carry, jnp.asarray(t_out),
                 jnp.asarray(fsptol), jnp.asarray(krytol))
        wj, carry = jr.w, jr.carry
    _compare_step(jfn, tfn, mask, np.asarray(wj), _carry_np(carry),
                  t_out, fsptol, krytol)


def test_step_fsp_rejection_matches_jax():
    """A state space too small for the step: the FSP criterion rejects and
    the step asks for expansion — same path in both packages."""
    jm, tm, jb, tb, mask = _toggle(extent=16, dilations=2)
    jfn, tfn = _step_fns(jm, tm, jb, tb, JConfig(), SolverConfig(),
                         jnp.float64, torch.float64)
    w = np.zeros(jb.volume)
    w[int(np.asarray(jb.flat_index(np.array([[0, 0]])))[0])] = 1.0
    carry = _carry_np(jstep.initial_carry(1.0, 10.0, 1e-10, 1.0, 10))
    jr, tr = _compare_step(jfn, tfn, mask, w, carry, 10.0, 1e-4, 1e-10)
    assert tr.iexpand


def test_step_float32_matches_jax():
    """float32 vectors: the incremental f32 FSP criterion (crit_floor)."""
    jm, tm, jb, tb, mask = _toggle(extent=64, dilations=16)
    jfn, tfn = _step_fns(jm, tm, jb, tb, JConfig(), SolverConfig(),
                         jnp.float32, torch.float32)
    w = np.zeros(jb.volume, np.float32)
    w[int(np.asarray(jb.flat_index(np.array([[0, 0]])))[0])] = 1.0
    carry = _carry_np(jstep.initial_carry(1.0, 5.0, 4e-6, 1.0, 10))
    _, tr = _compare_step(jfn, tfn, mask, w, carry, 5.0, 2e-5, 4e-6,
                          w_tol=1e-5)
    assert tr.w.dtype == torch.float32


def test_step_rejection_cap_iflag2_matches_jax():
    """mxreject > 0 with an absurd step size: IFLAG=2, w returned as is."""
    jm, tm, jb, tb, mask = _toggle(extent=16, dilations=8)
    jfn, tfn = _step_fns(jm, tm, jb, tb, JConfig(mxreject=3),
                         SolverConfig(mxreject=3), jnp.float64, torch.float64)
    w = np.zeros(jb.volume)
    w[int(np.asarray(jb.flat_index(np.array([[0, 0]])))[0])] = 1.0
    carry = _carry_np(jstep.initial_carry(1.0, 1e6, 1e-10, 1.0, 10))
    carry["t_new"] = np.asarray(1.0e3)
    _, tr = _compare_step(jfn, tfn, mask, w, carry, 1e6, 1e-4, 1e-10)
    assert int(tr.carry.iflag) == 2 and not tr.advanced


@pytest.mark.parametrize("t", [1e-3, 0.37, 12.0, 977.0])
def test_round_2sig_and_first_stepsize_match_jax(t):
    for add in (0.0, 0.55):
        assert float(tstep.round_2sig(t, add)) == pytest.approx(
            float(jstep.round_2sig(jnp.float64(t), add)), rel=1e-14)
    jc = jstep.initial_carry(0.7, t, 1e-10, 1.0, 10)
    tc = tstep.initial_carry(0.7, t, 1e-10, 1.0, 10)
    for k in tstep.StepCarry._fields:
        assert np.asarray(getattr(tc, k)).dtype == np.asarray(
            getattr(jc, k)).dtype, k
        assert float(getattr(tc, k)) == pytest.approx(
            float(getattr(jc, k)), rel=1e-14), k
