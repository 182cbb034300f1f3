"""The port's deliberate divergences in the FSP criterion loop, each held
against the JAX package's step from the same carry.

1. A step whose every FSP rejection was an overshoot (mass above 1 +
   bound) is shrunk as in the JAX package, but asks for no expansion; a
   step that fell short of the bound expands in both packages.  The
   overshoot is made by adding eps * x to the toggle generator on a box the
   distribution stays far inside (no truncation loss), so the mass grows
   at rate eps; eps < 0 loses mass instead.
2. A happy breakdown whose mass overshoots the criterion's ceiling at every
   shrink (its projected generator grows mass faster than the ceiling
   rises) is not abandoned: the port takes the step again with the
   reference's absolute breakdown threshold, where the JAX package returns
   the start vector and asks for an expansion.
3. A happy breakdown that the criterion accepts below the ceiling, but
   whose mass rose above the step's start by more than an accepted step's
   error, is taken again the same way (the JAX package keeps the gain).
4. A happy breakdown abandoned after falling short, on a chain that
   loses almost no mass (so no expansion can help), is taken again without
   a breakdown threshold (the JAX package returns the start vector and
   expands, and a solve repeats the step without end).  A birth-death
   solve that stalls so in the JAX package ends in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylovfspssa_tpu.boxspace.box import BoxSpace as JBox
from krylovfspssa_tpu.config import SolverConfig as JConfig
from krylovfspssa_tpu.krylov import stepper as jstep
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu.ops import stencil as jst
from krylovfspssa_tpu_torch.boxspace.box import BoxSpace as TBox
from krylovfspssa_tpu_torch.checkpoint import carry_from_numpy
from krylovfspssa_tpu_torch.config import SolverConfig
from krylovfspssa_tpu_torch.krylov import stepper as tstep
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.ops import stencil as tst

torch.set_num_threads(2)

T_OUT, FSPTOL, KRYTOL = 5.0, 1e-4, 1e-8
EXTENT = 256


def _boxes():
    jm, tm = jlib.toggle_file_model(), tlib.toggle_file_model()
    jb = JBox.for_model(jm.stoichiometry, [[0, 0]], min_log2=2)
    tb = TBox.for_model(tm.stoichiometry, [[0, 0]], min_log2=2)
    for s in range(2):
        while jb.extents[s] < EXTENT:
            jb, tb = jb.grow(s), tb.grow(s)
    return jm, tm, jb, tb


def _step_fns(jm, tm, jb, tb, eps):
    """Each package's step on the generator plus eps * I on the mask."""
    R = jm.n_reactions
    jmv = jst.make_stencil_matvec(jm, jb, jnp.float64)
    jdiag = jst.make_diag_fn(jm, jb)
    jfn = jax.jit(jstep.make_step_fn(
        lambda m: (lambda x: jmv(m, x) + eps * jnp.where(m, x, 0.0)),
        JConfig(),
        op_info=lambda m: (jnp.sum(m).astype(jnp.int32), R,
                           2.0 * jnp.max(jnp.where(m, jdiag(m), 0.0)))))
    tmv = tst.make_stencil_matvec(tm, tb, torch.float64)
    tdiag = tst.make_diag_fn(tm, tb)
    tfn = tstep.make_step_fn(
        lambda m: (lambda x: tmv(m, x) + eps * torch.where(m, x, 0.0)),
        SolverConfig(),
        lambda m: (int(m.sum()), R, 2.0 * float(torch.max(tdiag(m)))))
    return jfn, tfn


@pytest.fixture(scope="module")
def start():
    """Three JAX steps of the plain generator from x0 = (0, 0) on the
    whole box: a mid-solve carry with its adaptivity history."""
    jm, tm, jb, tb = _boxes()
    mask = np.ones(jb.volume, bool)
    jfn, _ = _step_fns(jm, tm, jb, tb, 0.0)
    w = np.zeros(jb.volume)
    w[int(np.asarray(jb.flat_index(np.array([[0, 0]])))[0])] = 1.0
    carry = jstep.initial_carry(1.0, T_OUT, KRYTOL, 1.0, 10)
    wj = jnp.asarray(w)
    for _ in range(3):
        jr = jfn(jnp.asarray(mask), wj, carry, jnp.asarray(T_OUT),
                 jnp.asarray(FSPTOL), jnp.asarray(KRYTOL))
        wj, carry = jr.w, jr.carry
    return (jm, tm, jb, tb), mask, np.asarray(wj), {
        k: np.asarray(v) for k, v in carry._asdict().items()}


@pytest.mark.parametrize("eps", [1e-4, 1e-3, -1e-4])
def test_overshoot_shrinks_without_expansion(start, eps):
    models, mask, w, carry = start
    jfn, tfn = _step_fns(*models, eps)
    jr = jfn(jnp.asarray(mask), jnp.asarray(w), jstep.StepCarry(
        **{k: jnp.asarray(v) for k, v in carry.items()}),
        jnp.asarray(T_OUT), jnp.asarray(FSPTOL), jnp.asarray(KRYTOL))
    tr = tfn(torch.from_numpy(mask), torch.from_numpy(w.copy()),
             carry_from_numpy(carry), T_OUT, FSPTOL, KRYTOL)
    # the same step: the FSP loop shrank it below the proposed step
    assert tr.advanced and bool(jr.advanced)
    assert tr.t_step == pytest.approx(float(jr.t_step), rel=1e-10)
    assert tr.t_step < float(carry["t_new"])
    assert (tr.wsum > 1.0) == (eps > 0)
    wj = np.asarray(jr.w)
    np.testing.assert_allclose(tr.w.numpy(), wj, rtol=0,
                               atol=1e-12 * np.abs(wj).max())
    for k in ("t_now", "t_new", "wsum_old", "nexph", "nstep"):
        assert float(getattr(tr.carry, k)) == pytest.approx(
            float(getattr(jr.carry, k)), rel=1e-10), k
    # JAX expands on every FSP rejection; the port only on a shortfall
    assert bool(jr.iexpand)
    assert tr.iexpand == (eps < 0)


def _birth_death(n=40, lam=10.0, mu=1.0):
    """A birth-death generator on 0..n-1 whose birth out of the top state
    is lost, and its quasi-stationary vector (mass 1)."""
    Q = np.zeros((n, n))
    for k in range(n):
        if k + 1 < n:
            Q[k + 1, k] += lam
        Q[k, k] -= lam
        if k > 0:
            Q[k - 1, k] += mu * k
            Q[k, k] -= mu * k
    ev, vecs = np.linalg.eig(Q)
    p = np.abs(vecs[:, np.argmax(ev.real)].real)
    return Q, p / p.sum()


def test_stall_at_ceiling_retakes_without_breakdown():
    """w = the quasi-stationary vector plus a zero-mass bump, at the mass
    ceiling 1 + fsptol * t_now / t_out.  Its Rayleigh quotient is positive
    and its residual (1.4e-4) under the scaled breakdown threshold (2e-4 at
    anorm_est 2e4), so column 1 breaks down and every shrink overshoots."""
    Q, p = _birth_death()
    n = Q.shape[0]
    t_out, fsptol, krytol, t_now, anorm = 1e4, 1e-4, 1e-10, 5e3, 2e4
    bump = np.zeros(n)
    bump[8], bump[9] = 1e-6, -1e-6
    w = (p + bump) * (1.0 + fsptol * t_now / t_out)
    jQ, tQ = jnp.asarray(Q), torch.from_numpy(Q)
    jfn = jax.jit(jstep.make_step_fn(
        lambda op: (lambda x: jQ @ x), JConfig(),
        op_info=lambda op: (jnp.int32(n), 2, anorm)))
    tfn = tstep.make_step_fn(lambda op: (lambda x: tQ @ x), SolverConfig(),
                             lambda op: (n, 2, anorm))
    carry = {k: np.asarray(v) for k, v in jstep.initial_carry(
        float(np.linalg.norm(w)), t_out, krytol, 1.0, 30)._asdict().items()}
    carry.update(t_now=np.float64(t_now), t_new=np.float64(1.0),
                 wsum_old=np.float64(w.sum()), nstep=np.int32(10))
    jr = jfn(jnp.ones(n, bool), jnp.asarray(w), jstep.StepCarry(
        **{k: jnp.asarray(v) for k, v in carry.items()}),
        jnp.asarray(t_out), jnp.asarray(fsptol), jnp.asarray(krytol))
    tr = tfn(torch.ones(n, dtype=torch.bool), torch.from_numpy(w.copy()),
             carry_from_numpy(carry), t_out, fsptol, krytol)
    # JAX: the breakdown step is abandoned at the ceiling and expands
    assert int(jr.carry.ibrkflag) == 1
    assert not bool(jr.advanced) and bool(jr.iexpand)
    assert float(jr.carry.t_now) == t_now
    # the port: taken again without the breakdown, and accepted
    assert tr.advanced and not tr.iexpand
    assert int(tr.carry.ibrkflag) == 0 and int(tr.carry.iflag) == 0
    t_new = float(tr.carry.t_now)
    assert t_new == pytest.approx(t_now + tr.t_step, rel=1e-15)
    b = fsptol * t_new / t_out
    assert 1.0 - b <= tr.wsum <= 1.0 + b
    # its counters keep the abandoned attempt's work
    assert int(tr.carry.nexph) > int(jr.carry.nexph)
    assert int(tr.carry.nmult) > int(jr.carry.nmult)


def _bd_steps(bump, anorm, t_out, t_now, krytol, dtype=np.float64,
              fsptol=1e-4):
    """Each package's step of the ``_birth_death`` chain from w = the
    quasi-stationary vector + ``bump`` (in ``dtype``; the matvec in
    float64) at t_now of t_out, with the operator-norm estimate ``anorm``
    (which scales the breakdown threshold).  Returns (JAX result, port
    result, the carry, mass at the start, the port's reads and retakes
    during its step)."""
    Q, p = _birth_death()
    n = Q.shape[0]
    w = (p + bump).astype(dtype)
    jQ, tQ = jnp.asarray(Q), torch.from_numpy(Q)
    jfn = jax.jit(jstep.make_step_fn(
        lambda op: (lambda x: (jQ @ x.astype(jnp.float64)).astype(x.dtype)),
        JConfig(), op_info=lambda op: (jnp.int32(n), 2, anorm)))
    tfn = tstep.make_step_fn(
        lambda op: (lambda x: (tQ @ x.double()).to(x.dtype)),
        SolverConfig(), lambda op: (n, 2, anorm))
    mass0 = float(w.astype(np.float64).sum())
    carry = {k: np.asarray(v) for k, v in jstep.initial_carry(
        float(np.linalg.norm(w.astype(np.float64))), t_out, krytol, 1.0,
        30)._asdict().items()}
    carry.update(t_now=np.float64(t_now), t_new=np.float64(1.0),
                 wsum_old=np.float64(mass0), nstep=np.int32(10))
    jr = jfn(jnp.ones(n, bool), jnp.asarray(w), jstep.StepCarry(
        **{k: jnp.asarray(v) for k, v in carry.items()}),
        jnp.asarray(t_out), jnp.asarray(fsptol), jnp.asarray(krytol))
    reads, retakes = tstep.READS, dict(tstep.RETAKES)
    tr = tfn(torch.ones(n, dtype=torch.bool), torch.from_numpy(w.copy()),
             carry_from_numpy(carry), t_out, fsptol, krytol)
    retakes = {k: v - retakes[k] for k, v in tstep.RETAKES.items()}
    return jr, tr, carry, mass0, tstep.READS - reads, retakes


def _allowance(krytol, t_step, mass0, eps, n=40):
    """The port's allowance for an accepted step's mass gain."""
    return 1.2 * krytol * t_step + (n * np.finfo(np.float64).eps
                                    + eps) * mass0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_breakdown_gain_below_ceiling_retakes(dtype):
    """Below the ceiling (mass 1 at t_now = t_out / 2 in float64): the JAX
    step accepts a column-1 breakdown whose mass rises by more than the
    allowance; the port takes it again without the breakdown and keeps the
    mass.  In float32 (one-sided criterion, krylov_tol at its floor) the
    allowance admits a gain of about 1.2 krylov_tol per time unit, so the
    case takes a longer horizon and a larger bump."""
    if dtype == np.float64:
        amp, anorm, t_out, krytol = 1e-6, 2e4, 1e4, 1e-10
    else:
        amp, anorm, t_out, krytol = 1e-4, 4e6, 1e5, 3.5e-4
    bump = np.zeros(40)
    bump[8], bump[9] = amp, -amp
    jr, tr, carry, mass0, reads, retakes = _bd_steps(
        bump, anorm, t_out, 5e3, krytol, dtype)
    eps = float(np.finfo(dtype).eps)
    # JAX: the breakdown step is accepted with its gain
    assert int(jr.carry.ibrkflag) == 1 and bool(jr.advanced)
    assert float(jr.wsum) - mass0 > _allowance(krytol, float(jr.t_step),
                                               mass0, eps)
    # the port: taken again without the breakdown, and accepted
    assert retakes == {"ceiling": 0, "gain": 1, "short": 0}
    assert tr.advanced and not tr.iexpand
    assert int(tr.carry.ibrkflag) == 0 and int(tr.carry.iflag) == 0
    assert tr.wsum <= mass0 + _allowance(krytol, tr.t_step, mass0, eps)
    assert float(tr.carry.t_now) == pytest.approx(5e3 + tr.t_step,
                                                  rel=1e-15)
    # its counters keep the first attempt's work (at least JAX's step)
    assert int(tr.carry.nexph) > int(jr.carry.nexph) - int(carry["nexph"])
    assert int(tr.carry.nmult) > int(jr.carry.nmult) - int(carry["nmult"])
    # one read per attempt (two), one per expm after it and, in float32,
    # the start mass, the pinned mass and the beta of each attempt
    extra = 2 if dtype == np.float64 else 2 + 2 * 3
    assert reads == int(tr.carry.nexph) - int(carry["nexph"]) + extra


def test_breakdown_without_gain_is_not_retaken():
    """The quasi-stationary vector itself: column 1 breaks down, the step
    loses only the chain's true leak, and both packages take the same
    step.  (The step's exp(tau * h11) turns an ulp of the Rayleigh quotient
    h11 into tau ulps of w: the remaining horizon is 1000.)"""
    jr, tr, carry, mass0, reads, retakes = _bd_steps(
        np.zeros(40), 2e4, 1e4, 9e3, 1e-10)
    assert retakes == {"ceiling": 0, "gain": 0, "short": 0}
    assert int(jr.carry.ibrkflag) == 1 and int(tr.carry.ibrkflag) == 1
    assert tr.advanced and bool(jr.advanced)
    assert tr.wsum <= mass0
    assert reads == int(tr.carry.nexph) - int(carry["nexph"]) + 1
    wj = np.asarray(jr.w)
    np.testing.assert_allclose(tr.w.numpy(), wj, rtol=0,
                               atol=1e-12 * np.abs(wj).max())
    for k in ("t_now", "t_new", "wsum_old", "beta", "nexph", "nmult",
              "nstep", "mbrkdwn"):
        assert float(getattr(tr.carry, k)) == pytest.approx(
            float(getattr(jr.carry, k)), rel=1e-12), k


@pytest.mark.parametrize("amp", [1e-6, 1e-7])
def test_breakdown_short_retakes_without_threshold(amp):
    """A bump that makes the Rayleigh quotient negative: column 1 breaks
    down and loses mass that the chain does not lose, every shrink falls
    short, and the JAX step is abandoned and asks for an expansion (which
    cannot help: the loss is the breakdown's).  The port takes the step
    again with no breakdown threshold, and advances with the true leak."""
    bump = np.zeros(40)
    bump[8], bump[9] = -amp, amp
    jr, tr, carry, mass0, reads, retakes = _bd_steps(
        bump, 2e4, 1e4, 5e3, 1e-10)
    assert int(jr.carry.ibrkflag) == 1
    assert not bool(jr.advanced) and bool(jr.iexpand)
    assert retakes == {"ceiling": 0, "gain": 0, "short": 1}
    assert tr.advanced and not tr.iexpand
    assert int(tr.carry.ibrkflag) == 0 and int(tr.carry.iflag) == 0
    assert 0.0 <= mass0 - tr.wsum <= 1e-9
    assert reads == int(tr.carry.nexph) - int(carry["nexph"]) + 2
    assert int(tr.carry.nexph) > int(jr.carry.nexph) - int(carry["nexph"])


#: models/birth_death_model.input (kp 1, kd 0.1) from X = 10, its
#: stationary mean, to t = 200 at fsp_tol 1e-6, at most 60 attempted steps
BD_STALL = dict(t=200.0, x0=[[10]], fsp_tol=1e-6, krylov_tol=1e-10)
BD_MXSTEP = 60


def _bd_model(load_model):
    from _birth_death import PATH

    model = load_model(PATH)
    model.reset_parameters([1.0, 0.1])
    return model


def test_birth_death_stalls_in_jax():
    """Near stationarity column 1 breaks down and loses mass at every
    shrink, and the JAX stepwise loop retries that step until it runs out
    of attempts (the port ends within the same cap, below)."""
    from krylovfspssa_tpu.boxsolver import solve_cme_box as jsolve
    from krylovfspssa_tpu.models.model import load_model

    args = dict(BD_STALL)
    with pytest.raises(RuntimeError, match=f"exceeded {BD_MXSTEP} attempted"):
        jsolve(_bd_model(load_model), args.pop("t"), args.pop("x0"),
               config=JConfig(fused_steps=False, mxstep=BD_MXSTEP), **args)


@pytest.mark.parametrize("fused", [True, False])
def test_birth_death_solve_ends(fused):
    """The birth-death solve that stalls in the JAX package: the port
    takes the breakdown step again without a threshold and ends within
    fsp_tol of the closed form, with no mass gained, within the cap of
    attempted steps that the JAX loop exceeds."""
    from _birth_death import exact

    from krylovfspssa_tpu_torch import solve_cme_box
    from krylovfspssa_tpu_torch.models.model import load_model

    before = dict(tstep.RETAKES)
    args = dict(BD_STALL)
    r = solve_cme_box(_bd_model(load_model), args.pop("t"), args.pop("x0"),
                      device="cpu", config=SolverConfig(
                          fused_steps=fused, mxstep=BD_MXSTEP), **args)
    assert tstep.RETAKES["short"] > before["short"]
    assert r.stats.iflag == 0 and r.stats.t_final == 200.0
    assert 1.0 - 1e-6 <= r.wsum <= 1.0 + 1e-6
    n_max = int(r.states[:, 0].max())
    got = np.zeros(n_max + 1)
    got[r.states[:, 0]] = r.probabilities
    ref = exact(n_max, x0=10, t=200.0)
    assert float(np.abs(got - ref).sum()) + (1.0 - ref.sum()) <= 2e-6
