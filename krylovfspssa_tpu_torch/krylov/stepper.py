"""Adaptive Krylov time step — the core of DGEXPV_FSP (PyTorch port of
``krylovfspssa_tpu/krylov/stepper.py``).

One call to the function built by :func:`make_step_fn` performs exactly one
*attempted* time step of the reference algorithm
(``reference/src/fsp/KrylovSolver.f90:206-550``):

  * IOP Arnoldi factorization (resumable on Krylov-dimension growth),
  * Padé exponential of the augmented Hessenberg,
  * the Sidje local error estimate with NaN step-shrink retry
    (KrylovSolver.f90:289-310),
  * Niesen–Wright step-size/dimension adaptivity with the flop-cost model
    (KrylovSolver.f90:313-373,618-639),
  * the rejection loop (shrink tau, or grow m and resume Arnoldi;
    KrylovSolver.f90:375-434),
  * the FSP probability-mass criterion loop with its own step shrinking and
    the 5-rejection SSA bailout (KrylovSolver.f90:442-495).

The JAX package runs these as nested ``lax.while_loop``s on device.  Here
they are Python loops: the vectors (the probability vector, the Krylov
basis, the Hessenberg and its exponential) stay on the solve's device, and
the controller's scalars live on the host as numpy float64 / int32 / bool
values — IEEE double arithmetic with the same inf/NaN semantics as the
JAX package's x64 scalars, and no dependence on torch's default dtype.
The controller's float32-mode cost-model terms are evaluated in float64
(the JAX package mixes in some float32 products there).

The host reads the device a bounded number of times per attempted step,
independent of the Krylov dimension, every read through :func:`read`
(counted in ``READS``): the Arnoldi extension reads nothing (its
breakdown, broken column, avnorm and matvec count stay on the device); a
breakdown sets the expm's block size and time on the device, where the
``expm_pade`` kernel reads them; then ONE stacked float64 read brings
back the Arnoldi outcome, E[m,0], E[m+1,0], hnorm and ns, and the
controller runs its arithmetic.  A NaN retry adds one read, and each FSP
evaluation one (its mass and the sum of squares that gives the accepted
step's beta).  On one card the Arnoldi columns replay as CUDA graphs
(krylov/graphs.py) when the caller names the geometry's matvec.

Deliberate divergences from the JAX package, all in the FSP criterion
loop (ROADMAP.md Queue C): a step whose every rejection was an overshoot
asks for no expansion; and a happy-breakdown step is taken again, once,
with the reference's absolute breakdown threshold when it was abandoned at
the criterion's ceiling, or when the criterion accepted it although its
mass rose above the step's start by more than an accepted step's error,
and with none when it was abandoned short of the criterion (``RETAKES``
counts the three causes).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import SolverConfig
from ..ops.expm import expm_chebyshev_col0, expm_pade
from ..utils.trace import span, spanned
from .arnoldi import arnoldi_extend

_SQR1 = math.sqrt(0.1)
EPS = float(np.finfo(np.float64).eps)
_F64 = np.float64

#: the stepper's device reads (each one host sync on the card), a plain
#: counter a run resets and reads
READS = 0
#: happy-breakdown steps taken again, by cause: ``"ceiling"`` (abandoned
#: at the FSP criterion's ceiling) and ``"gain"`` (accepted with a mass
#: gain beyond the step's error), both retaken with the absolute breakdown
#: threshold, and ``"short"`` (abandoned below the criterion), retaken with
#: none; a run resets and reads it as it does ``READS``
RETAKES = {"ceiling": 0, "gain": 0, "short": 0}


def read(t: torch.Tensor) -> list:
    """The values of a 1-d tensor as Python floats: every read of the
    stepper goes through here, and adds one to ``READS``."""
    global READS
    READS += 1
    with span("read"):
        return t.tolist()


def _pick(cond: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """A 0-d float64 tensor on cond's device: a where cond, else b (each
    filled in by a kernel, no host copy)."""
    return torch.full((), b, dtype=torch.float64,
                      device=cond.device).masked_fill_(cond, a)


def _nint(x):
    """Fortran NINT for the positive arguments used here."""
    return np.floor(x + 0.5)


def _to_i32(x) -> int:
    """float -> int32 with saturation (NaN -> 0), as XLA converts."""
    if np.isnan(x):
        return 0
    return int(np.clip(x, -2.0 ** 31, 2.0 ** 31 - 1))


def round_2sig(t, add: float):
    """Reference step rounding to ~2 significant digits
    (KrylovSolver.f90:186-187 et al.): p1 = 10**(NINT(log10 t - sqrt(.1))-1);
    t = AINT(t/p1 + add) * p1 with add in {0.55, 0.0}."""
    with np.errstate(all="ignore"):
        t = _F64(t)
        p1 = 10.0 ** (_nint(np.log10(t) - _SQR1) - 1.0)
        return np.trunc(t / p1 + add) * p1


def first_stepsize(m, beta, krytol, anorm, t_out):
    """Very first step size (KrylovSolver.f90:182-187)."""
    m, beta, krytol, anorm = map(_F64, (m, beta, krytol, anorm))
    xm = 1.0 / m
    p1 = krytol * (((m + 1) / 2.72) ** (m + 1)) * np.sqrt(2.0 * 3.14 * (m + 1))
    t_new = (1.0 / anorm) * (p1 / (4.0 * beta * anorm)) ** xm
    return round_2sig(t_new, 0.55)


class StepCarry(NamedTuple):
    """Scalar state carried between accepted steps (the reference's locals
    that survive the GOTO-100 loop), as numpy scalars on the host."""

    t_now: np.float64
    t_new: np.float64
    beta: np.float64
    wsum_old: np.float64
    m_new: np.int32
    # --- adaptivity history (persist across steps in the reference) ---
    omega: np.float64
    t_old: np.float64
    m_old: np.int32
    order: np.float64
    kfactor: np.float64
    orderold: np.bool_
    kestold: np.bool_
    # --- statistics (IWSP/WSP, KrylovSolver.f90:554-573) ---
    nstep: np.int32
    nmult: np.int32
    nexph: np.int32
    nscale: np.int32
    nreject: np.int32
    ibrkflag: np.int32
    mbrkdwn: np.int32
    tbrkdwn: np.float64
    step_min: np.float64
    step_max: np.float64
    s_error: np.float64
    x_error: np.float64
    hump: np.float64
    vnorm: np.float64
    #: failure code: 0 ok, 2 = too many step rejections, 3 = the local
    #: error stayed NaN through the bounded tau/5 retry
    iflag: np.int32
    #: cumulative measured probability-mass loss (step truncation + drops);
    #: drives the float32 FSP criterion and drop budget
    spent: np.float64


_CARRY_INT = frozenset(
    {"m_new", "m_old", "nstep", "nmult", "nexph", "nscale", "nreject",
     "ibrkflag", "mbrkdwn", "iflag"}
)
_CARRY_BOOL = frozenset({"orderold", "kestold"})


def carry_from_numpy(fields) -> StepCarry:
    """A StepCarry from a mapping of field name -> scalar or 0-d array
    (numpy, torch or JAX), with each field coerced to its numpy type
    (int32 counters, bool flags, float64 otherwise).  This is how a carry
    written by either package is read back."""
    out = {}
    for k in StepCarry._fields:
        v = np.asarray(fields[k]).reshape(())
        if k in _CARRY_INT:
            out[k] = np.int32(v)
        elif k in _CARRY_BOOL:
            out[k] = np.bool_(v)
        else:
            out[k] = _F64(v)
    return StepCarry(**out)


class StepResult(NamedTuple):
    w: torch.Tensor
    carry: StepCarry
    #: True if t_now advanced (False only on the FSP-abandon/fail path)
    advanced: bool
    #: expansion requested (FSP criterion failed at least once this step)
    iexpand: bool
    #: SSA time horizon to use if expanding (already min'd with remaining
    #: time, KrylovSolver.f90:520-521)
    t_ssa: float
    #: droppable surplus mass; the caller drops states if > 0
    #: (KrylovSolver.f90:509-511)
    dsum: float
    wsum: float
    t_step: float
    m_used: int
    err_loc: float


def initial_carry(beta, t_out, krytol, anorm, m0: int) -> StepCarry:
    t_new = first_stepsize(float(m0), beta, krytol, anorm, t_out)
    return carry_from_numpy(dict(
        t_now=0.0, t_new=t_new, beta=beta, wsum_old=1.0, m_new=m0,
        omega=0.0, t_old=0.0, m_old=m0, order=float(m0) / 4.0, kfactor=2.0,
        orderold=True, kestold=True,
        nstep=0, nmult=0, nexph=0, nscale=0, nreject=0, ibrkflag=0,
        mbrkdwn=m0, tbrkdwn=0.0, step_min=t_out, step_max=0.0,
        s_error=0.0, x_error=0.0, hump=beta, vnorm=beta, iflag=0, spent=0.0,
    ))


def make_step_fn(
    matvec_builder: Callable,
    config: SolverConfig,
    op_info: Callable,
    reduce: Callable | None = None,
    basis: dict | None = None,
    graph_matvec: Callable | None = None,
):
    """Build the single-attempted-step function.

    Args:
      matvec_builder: op -> (x -> A@x) closure factory; ``op`` is the box
        backend's mask.
      config: solver constants.
      op_info: op -> (n_active, n_reactions[, anorm_est]) host numbers for
        the cost model, the Krylov dimension bound and the scaled
        breakdown threshold.
      reduce: a mesh's ``sum`` when ``op`` and ``w`` are this rank's rows
        of a row-sharded box: every sum over the cell axis (Arnoldi dots,
        FSP mass, norms) then runs over all ranks, and every rank takes the
        same branches.  None on one device.
      basis: the dict that holds the Krylov basis, the Hessenberg and the
        column graphs.  Step functions given the same dict share one
        basis, so that one geometry's basis is freed when another's is
        allocated (with every graph that wrote into it); by default each
        step function keeps its own.
      graph_matvec: the box geometry's ``matvec(mask, x)``, or None (the
        table backend).  On one card (no ``reduce``, ``w`` on a CUDA
        device) the Arnoldi columns then replay as CUDA graphs of that
        matvec on the step's mask (krylov/graphs.py), keyed by it; they
        run eagerly otherwise (the CPU, a mesh, the table backend).

    Returns:
      step(op, w, carry, t_out, fsptol, krytol) -> StepResult.  The Krylov
      basis ((m_max+2) vectors of w's size, dtype and device) is allocated
      on the first call and reused by every later call with the same w
      layout.
    """
    m_min = config.m_min
    m_max = config.m_max
    qiop = config.qiop
    delta = config.delta
    gamma = config.gamma
    ideg = config.ideg
    break_tol = config.break_tol
    anorm = config.anorm
    max_fsp_rejects = config.max_fsp_rejects
    mxreject = config.mxreject
    MH = m_max + 2

    # ideg == 0 selects the Chebyshev partial-fraction expv instead of Padé
    # (KrylovSolver.f90:278-287; dead code at the reference default ideg=6)
    if ideg == 0:
        def expm_fn(Hb, mxv, ts, _ideg):
            return expm_chebyshev_col0(Hb, mxv, ts)
    else:
        expm_fn = expm_pade

    if basis is None:
        basis = {}

    def total(t):
        """A float64 sum over the cell axis (over every rank's rows)."""
        return t if reduce is None else reduce(t)

    def get_basis(w):
        key = (MH, w.shape[0], w.dtype, w.device)
        if basis.get("key") != key:
            # drops the column graphs that wrote into the old basis too
            basis.clear()
            basis["key"] = key
            basis["V"] = torch.zeros((MH, w.shape[0]), dtype=w.dtype,
                                     device=w.device)
            # the Hessenberg is tiny and always float64
            basis["H"] = torch.zeros((MH, MH), dtype=torch.float64,
                                     device=w.device)
            basis["graphs"] = {}
        return basis["V"], basis["H"]

    def get_graphs(op, w):
        if graph_matvec is None or reduce is not None \
                or w.device.type != "cuda":
            return None
        graphs = basis["graphs"].get(graph_matvec)
        if graphs is None:
            from .graphs import ColumnGraphs

            graphs = basis["graphs"][graph_matvec] = ColumnGraphs(
                graph_matvec, op)
        return graphs

    @spanned("step")
    def step(op, w, sc: StepCarry, t_out, fsptol, krytol) -> StepResult:
        args = (_F64(t_out), _F64(fsptol), _F64(krytol))
        with np.errstate(all="ignore"):
            res, retake = _step(op, w, sc, *args, None)
            if retake is None:
                return res
            # a happy breakdown whose neglected residual moved the mass:
            # abandoned at the criterion's ceiling ("ceiling": it gains
            # faster than the ceiling rises, so it would stall there; the
            # JAX package abandons the step and expands, and the expansions
            # overflow the box), accepted below it ("gain": the exact step
            # cannot raise the mass, and the gains carry the solve up to
            # the ceiling), or abandoned short of the criterion ("short":
            # where the loss is the breakdown's own, no expansion recovers
            # it, and the JAX loops retry the step without end; ROADMAP.md
            # Queue C).  Take the step again, once, so that the Arnoldi
            # process runs on under error control: with the reference's
            # absolute breakdown threshold, or, after a shortfall, none
            # (that breakdown may have been under the absolute one
            # already).  The counters keep the first attempt's work.
            RETAKES[retake] += 1
            c = res.carry
            return _step(op, w, sc._replace(
                nmult=c.nmult, nexph=c.nexph, nscale=c.nscale,
                nreject=c.nreject), *args,
                0.0 if retake == "short" else _F64(break_tol))[0]

    def _step(op, w, sc, t_out, fsptol, krytol, retake_tol):
        """One attempted step with the breakdown threshold ``retake_tol``
        (None: scaled to the operator norm): (StepResult, retake), where
        ``retake`` is None, or the cause for which a happy-breakdown step
        is to be taken again: ``"ceiling"``, abandoned at the FSP
        criterion's ceiling (every rejection an overshoot), ``"gain"``,
        accepted with its mass above the step's start by more than the
        step's error, or ``"short"``, abandoned after a shortfall."""
        matvec = matvec_builder(op)
        f = w.dtype
        info = op_info(op)
        if len(info) == 3:
            n, n_reactions, anorm_est = info
        else:
            n, n_reactions = info
            anorm_est = 1.0
        # happy-breakdown threshold scaled to the OPERATOR norm (the
        # reference's absolute BREAK_TOL=1e-7, KrylovSolver.f90:173,249,
        # assumes ||A|| ~ O(1); CME generators have ||A|| ~ 1e2-1e5).  See
        # the JAX package's stepper.py for the measurements behind 0.1.
        # A breakdown step taken again (step) uses the absolute one or none.
        break_eff = break_tol * np.maximum(1.0, 0.1 * _F64(anorm_est)) \
            if retake_tol is None else retake_tol
        n = int(n)
        nnz = _F64((n_reactions + 1) * n)  # KrylovSolver.f90:196,537
        nf = _F64(n)
        sgn = float(np.sign(t_out))
        t_out_abs = abs(t_out)
        rndoff = EPS * anorm
        # float32 mode: the FSP criterion is *incremental* — each step's
        # measured loss is charged against its pro-rata allowance plus a
        # per-step noise floor RESERVED out of the budget (see the JAX
        # package's stepper.py and config.f32_criterion_floor_ulps)
        crit_floor = config.f32_criterion_floor() if f == torch.float32 \
            else 0.0

        def bound(tx):
            # FERRORBOUND (KrylovSolver.f90:609-616)
            if crit_floor:
                return tx * np.maximum(fsptol - crit_floor, 0.0) / t_out_abs
            return tx * fsptol / t_out_abs

        def krylov_cost(tau, m, hnorm):
            # KrylovSolver.f90:618-639
            mf = _F64(m)
            th = tau * hnorm
            lg = np.log(np.maximum(th, 1e-300)) / np.log(2.0)
            nom = 25.0 / 3.0 + np.maximum(0.0, 2.0 + np.trunc(lg)) \
                if th > 0 else _F64(25.0 / 3.0)
            steps = _nint((t_out_abs - sc.t_now) / tau)
            q = float(qiop)
            return steps * (
                2.0 * (mf + 1.0) * nnz
                + (5.0 * mf + 4.0 * q * mf + 2.0 * q - 2.0 * q * q + 7.0) * nf
                + 2.0 * nom * (mf + 2.0) ** 3
            )

        # ------------------------------------------------ step set-up ----
        wsum_start = (
            _F64(read(total(torch.sum(w, dtype=torch.float64)).reshape(1))[0])
            if crit_floor else None
        )
        t_step = np.minimum(t_out_abs - sc.t_now, sc.t_new)
        m = min(n - 1, int(sc.m_new))
        # m_new can carry a larger value across geometries whose memory
        # clamp (config.max_basis_bytes) lowered this step's m_max
        m = max(min(m, m_max), 1)
        beta = sc.beta

        V, H = get_basis(w)
        V[0] = (w.to(torch.float64) / float(beta)).to(f)
        H.zero_()
        graphs = get_graphs(op, w)
        if graphs is not None:
            graphs.load(op, break_eff)

        # ---------------------------------------------- attempt loop -----
        jold, needs_arnoldi = 1, True
        t_new, m_new = sc.t_new, int(sc.m_new)
        k1, mbrk, avnorm = 2, m, 0.0
        E, err_loc = None, _F64(0.0)
        ireject = imreject = 0
        omega, t_old, m_old = sc.omega, sc.t_old, int(sc.m_old)
        order, kfactor = sc.order, sc.kfactor
        orderold, kestold = bool(sc.orderold), bool(sc.kestold)
        accept = brk = nanfail = False
        nmult = nexph = nscale = nreject = 0
        # the reference's rejection loop is unbounded (MXREJECT=0 default,
        # KrylovSolver.f90:392-397); 512 rejections mean the controller is
        # stuck, surfaced as IFLAG=2
        hard_attempts = mxreject if mxreject > 0 else 512

        while not accept and not nanfail \
                and ireject + imreject <= hard_attempts:
            # ---- Arnoldi phase (labels 101-300) -------------------------
            head = ()
            if needs_arnoldi:
                st = arnoldi_extend(matvec, V, H, jold, m, qiop, break_eff,
                                    reduce, graphs)
                needs_arnoldi = False
                # a breakdown sets the expm's block (mb) and its time (the
                # rest of the interval) on the device
                mx_arg = torch.where(st.breakdown, st.mbrkdwn, m + 2)
                t_arg = _pick(st.breakdown, sgn * (t_out_abs - sc.t_now),
                              sgn * t_step)
                head = (st.breakdown.to(torch.float64),
                        st.mbrkdwn.to(torch.float64), st.avnorm,
                        st.nmult.to(torch.float64))
            else:
                mx_arg, t_arg = mbrk + k1, sgn * t_step

            # ---- expm + local error, with NaN tau/5 retry (401-310) -----
            Hbar = H.clone()
            # fill_, not Hbar[...] = 1.0: an assigned number is a host copy
            Hbar[m + 1, m].fill_(1.0)

            def expm_read(mx_arg, t_arg, head=()):
                """The expm and THE read of an attempt: the Arnoldi
                outcome ``head`` (if any), E[m,0], E[m+1,0], hnorm, ns."""
                with span("expm"):
                    E, hnorm, ns = expm_fn(Hbar, mx_arg, t_arg, ideg)
                vals = read(torch.stack(
                    [*head, E[m, 0], E[m + 1, 0], hnorm, ns]))
                return E, vals

            def local_error(e_m, e_m1):
                if k1 == 0:
                    return krytol
                p1 = abs(e_m) * beta
                p2 = abs(e_m1) * beta * avnorm
                if p1 > 10.0 * p2:
                    err = p2
                elif p1 > p2:
                    err = (p1 * p2) / (p1 - p2)
                else:
                    err = p1
                return _F64(err)

            E, vals = expm_read(mx_arg, t_arg, head)
            if head:
                brk = vals[0] > 0
                k1 = 0 if brk else 2
                mbrk = int(vals[1]) if brk else m
                avnorm = vals[2]
                nmult += int(vals[3])
                if brk:
                    t_step = t_out_abs - sc.t_now
                vals = vals[4:]
            e_m, e_m1, hnorm, ns = vals
            err_loc = local_error(e_m, e_m1)
            nexph += 1
            nscale += int(ns)
            # bounded tau/5 retry (KrylovSolver.f90:307-310 is an unbounded
            # GOTO): a NaN that survives 40 shrinks (5^40 ~ 1e28) is
            # structural, so the step exits with iflag=3
            tries = 0
            while np.isnan(err_loc) and tries < 40:
                t_step = t_step / 5.0
                E, (e_m, e_m1, hnorm, ns) = expm_read(mbrk + k1,
                                                      sgn * t_step)
                err_loc = local_error(e_m, e_m1)
                nexph += 1
                nscale += int(ns)
                tries += 1
            nanfail = bool(np.isnan(err_loc))

            # ---- omega + order/kappa estimation (312-337) ---------------
            omega_old = omega
            # floor: err_loc can underflow to exactly 0, and log(0/0) in
            # the order estimator would poison t_new
            omega = np.maximum(err_loc, 1e-300) / (krytol * t_step)

            use_order_est = (m == m_old) and (t_step != t_old) \
                and ireject >= 1
            if use_order_est:
                order = np.maximum(
                    1.0, np.log(omega / omega_old) / np.log(t_step / t_old)
                )
            elif orderold or ireject == 0:
                order = _F64(m / 4.0)
            orderold = not use_order_est

            use_k_est = (m != m_old) and (t_step == t_old) and ireject >= 1
            if use_k_est:
                kfactor = np.maximum(
                    1.1, (omega / omega_old) ** (1.0 / _F64(m_old - m))
                )
            elif kestold or ireject == 0:
                kfactor = _F64(2.0)
            kestold = not use_k_est

            t_old = t_step
            m_old = m

            # ---- new step/dimension suggestion (339-373) ----------------
            t_shrunk = np.minimum(
                t_out_abs - sc.t_now,
                np.maximum(
                    t_step / 5.0,
                    np.minimum(
                        5.0 * t_step,
                        gamma * t_step * omega ** (-1.0 / order),
                    ),
                ),
            )
            force_tau = (m == m_max and omega > delta) or imreject > 4
            m_opt = min(
                max(max(m_min, 3 * m // 4),
                    m + _to_i32(np.ceil(np.log(omega) / np.log(kfactor)))),
                m_max,
                _to_i32(np.ceil(4.0 * m / 3.0) + 1),
            )
            prefer_tau = krylov_cost(t_shrunk, m, hnorm) \
                <= krylov_cost(t_step, m_opt, hnorm)
            keep_m = force_tau or prefer_tau
            t_new = round_2sig(t_shrunk, 0.0) if keep_m else t_step
            m_new = m if keep_m else m_opt

            # ---- rejection decision (375-434) ---------------------------
            if k1 != 0 and omega > delta:
                nreject += 1
                if keep_m:
                    ts = np.minimum(
                        t_out_abs - sc.t_now,
                        np.maximum(t_step / 5.0,
                                   np.minimum(5.0 * t_step, t_new)),
                    )
                    t_step = round_2sig(ts, 0.55)
                    ireject += 1
                else:
                    m, jold, mbrk, k1 = m_new, m_old, m_new, 2
                    t_step = np.minimum(t_out_abs - sc.t_now, t_new)
                    needs_arnoldi = True
                    imreject += 1
            else:
                accept = True

        #: rejection-budget exhaustion (mxreject > 0) or persistent NaN
        fail = (not accept) or nanfail

        # grow next step aggressively on tiny error (KrylovSolver.f90:437)
        t_new_acc = np.maximum(t_new, 2.0 * t_step) if err_loc < 1.0e-16 \
            else t_new
        mx = mbrk + max(0, k1 - 1)

        # ------------------------------- FSP criterion loop (442-495) ----
        Hbar = H.clone()
        Hbar[m + 1, m].fill_(1.0)
        if crit_floor:
            # float64 column sums of the basis: the criterion mass is then
            # measured entirely in f64, free of w-assembly rounding noise
            colsum = total(torch.sum(V[:mx], dim=1, dtype=torch.float64))

        def assemble_w(E):
            # w = beta * V @ E[:,0] (KrylovSolver.f90:444)
            coeff = (E[:mx, 0] * float(beta)).to(f)
            wc = coeff @ V[:mx]
            if crit_floor:
                # f32: keep the signed vector (results are clipped once at
                # reporting instead of every step)
                return wc
            return torch.clamp_min(wc, 0.0)

        @spanned("fsp_check")
        def fsp_check(E, t_step, ns=None, start=False):
            """ONE read: (assembled w or None, wsum, ok, short, the other
            values read).  ``short``: the mass fell below the criterion (a
            failure that is not an overshoot).  The values are the sum of
            squares of w (float64 mode), the start vector's (``start``: for
            a step that may not advance) and ``ns`` (a re-evaluation's
            squaring count), in that order."""
            extra = () if ns is None else (ns.reshape(1),)
            if crit_floor:
                vals = read(torch.cat([
                    torch.sum(E[:mx, 0] * colsum).reshape(1), *extra]))
                wsum = beta * vals[0]
                ok = (sc.spent + (wsum_start - wsum)) <= (
                    bound(sc.t_now + t_step) + crit_floor
                )
                return None, wsum, bool(ok), not ok, vals[1:]
            w_c = assemble_w(E)
            sums = [torch.sum(w_c, dtype=torch.float64),
                    torch.sum(w_c * w_c, dtype=torch.float64)]
            if start:
                w0 = V[0] * float(beta)
                sums.append(torch.sum(w0 * w0, dtype=torch.float64))
            vals = read(torch.cat([total(torch.stack(sums)), *extra]))
            # TWO-SIDED float64 mass criterion: true mass never exceeds 1,
            # so an overshoot beyond the budget is equally disqualifying
            # (the reference checks only wsum >= 1 - bound,
            # KrylovSolver.f90:458)
            wsum = _F64(vals[0])
            b = bound(sc.t_now + t_step)
            short = not wsum >= 1.0 - b  # a NaN mass counts as short
            return (w_c, wsum, bool(not short and wsum <= 1.0 + b),
                    short, vals[1:])

        fc_E, fc_t = E, t_step
        fc_w, fc_wsum, ok, shortfall, fc_vals = fsp_check(E, t_step,
                                                          start=fail)
        start_sq = fc_vals[1] if fail and not crit_floor else None
        irejectfsp, error_old, tau_old, abandon = 0, _F64(1.0), t_step, False
        while not ok and not abandon and not fail:
            # criterion failed: shrink the step via the FSP order model
            irejectfsp += 1
            error = abs(
                (wsum_start - fc_wsum) if crit_floor
                else sc.wsum_old - fc_wsum
            )
            abandon = irejectfsp >= max_fsp_rejects
            err_safe = np.maximum(error, 1e-300)
            if irejectfsp == 1:
                fsporder = _F64(2.0)
            else:
                fsporder = (
                    np.log(err_safe / np.maximum(error_old, 1e-300))
                    / np.log(fc_t / tau_old) - 1.0
                )
            tfsp = gamma * fc_t * (
                fsptol * fc_t / (err_safe * t_out_abs)
            ) ** (1.0 / fsporder)
            ts = np.minimum(
                t_out_abs - sc.t_now,
                np.maximum(fc_t / 5.0, np.minimum(0.9 * fc_t, tfsp)),
            )
            ts = round_2sig(ts, 0.55)
            with span("expm"):
                fc_E, _, ns = expm_fn(Hbar, mx, sgn * ts, ideg)
            error_old, tau_old, fc_t = error, fc_t, ts
            # the last allowed shrink also reads the start vector's sum of
            # squares, for an abandoned step's beta
            want_start = abandon and not crit_floor
            w_c, fc_wsum, ok, short, fc_vals = fsp_check(
                fc_E, fc_t, ns, start=want_start)
            shortfall = shortfall or short
            if want_start:
                start_sq = fc_vals[1]
            nexph += 1
            nscale += int(fc_vals[-1])
            if w_c is not None:
                fc_w = w_c
        # a final shrink that satisfies the criterion is an accepted step
        abandon = abandon and not ok
        if crit_floor and not (abandon or fail):
            fc_w = assemble_w(fc_E)

        fsp_rejected = (irejectfsp > 0 or abandon) and not fail
        # an accepted step whose every FSP rejection was an overshoot (mass
        # above 1 + bound: the error of a happy-breakdown step, not a
        # truncation loss) asks for no expansion: states added with zero
        # mass cannot lower it.  The JAX package expands on every
        # rejection; over a breakdown step's horizon of hundreds of time
        # units those walks can overflow the box (ROADMAP.md Queue C).
        iexpand = fsp_rejected and (shortfall or abandon)

        # --------------------------- post-step bookkeeping (497-550) -----
        # abandon / IFLAG=2 paths return the step's starting vector
        advanced = not abandon and not fail
        w_final = fc_w if advanced else V[0] * float(beta)
        t_now_new = sc.t_now + fc_t if advanced else sc.t_now
        wsum_new = fc_wsum if advanced else sc.wsum_old
        nstep_new = int(sc.nstep) + (1 if advanced else 0)
        done = t_now_new >= t_out_abs

        if crit_floor:
            loss_step = wsum_start - fc_wsum
        else:
            loss_step = sc.wsum_old - fc_wsum
        spent_new = np.maximum(
            sc.spent + (loss_step if advanced else 0.0), 0.0
        )

        if crit_floor:
            # f32: pin the stored mass to the f64 bookkeeping (1 - spent)
            target = 1.0 - spent_new
            actual = read(total(torch.sum(
                w_final, dtype=torch.float64)).reshape(1))[0]
            if advanced and actual > 0.0:
                w_final = w_final * float(target / actual)
            wsum_new = target if advanced else sc.wsum_old

        # drop surplus (509-511); the caller acts when dsum > 0
        if crit_floor:
            dsum_raw = np.maximum(bound(t_now_new) - spent_new, 0.0)
        else:
            dsum_raw = fc_wsum - (1.0 - bound(t_now_new))
        can_drop = advanced and not done and nstep_new > 1 \
            and not fsp_rejected
        dsum = dsum_raw if can_drop else _F64(0.0)

        # SSA horizon (518-521): when expanding on the first step,
        # t_new := t_step
        t_new_eff = fc_t if (fsp_rejected and nstep_new == 1) \
            else t_new_acc
        t_ssa = np.minimum(t_new_eff, t_out_abs - t_now_new)

        if crit_floor:
            beta_new = math.sqrt(read(total(torch.sum(
                w_final * w_final, dtype=torch.float64)).reshape(1))[0])
        else:
            # the last FSP read's sum of squares of w_final
            beta_new = math.sqrt(fc_vals[0] if advanced else start_sq)
        err_final = np.maximum(err_loc, rndoff)
        carry = carry_from_numpy(dict(
            t_now=t_now_new,
            t_new=round_2sig(t_new_eff, 0.55),
            beta=beta_new,
            wsum_old=wsum_new,
            m_new=m_new,
            omega=omega,
            t_old=t_old,
            m_old=m_old,
            order=order,
            kfactor=kfactor,
            orderold=orderold,
            kestold=kestold,
            nstep=nstep_new,
            nmult=int(sc.nmult) + nmult,
            nexph=int(sc.nexph) + nexph,
            nscale=int(sc.nscale) + nscale,
            nreject=int(sc.nreject) + nreject,
            ibrkflag=1 if brk else sc.ibrkflag,
            mbrkdwn=mbrk if brk else sc.mbrkdwn,
            tbrkdwn=sc.t_now if brk else sc.tbrkdwn,
            step_min=np.minimum(sc.step_min, fc_t) if advanced
            else sc.step_min,
            step_max=np.maximum(sc.step_max, fc_t) if advanced
            else sc.step_max,
            s_error=sc.s_error + (err_final if advanced else 0.0),
            x_error=np.maximum(sc.x_error, err_final),
            hump=np.maximum(sc.hump, beta_new),
            vnorm=sc.vnorm,
            iflag=(3 if nanfail else 2) if fail else sc.iflag,
            spent=spent_new,
        ))
        # an accepted step's mass may exceed its start by its error
        # (omega <= delta) and by the round-off of the float64 sum and of
        # w's rounding to its dtype; a breakdown step beyond that gained
        # mass through its neglected residual (the FSP generator is
        # sub-stochastic)
        mass0 = wsum_start if crit_floor else sc.wsum_old
        allowance = delta * krytol * fc_t \
            + (n * EPS + torch.finfo(f).eps) * mass0
        retake = None
        if abandon and brk:
            retake = "short" if shortfall else "ceiling"
        elif advanced and brk and fc_wsum - mass0 > allowance:
            retake = "gain"
        return StepResult(
            w=w_final,
            carry=carry,
            advanced=advanced,
            iexpand=iexpand and t_now_new < t_out_abs,
            t_ssa=float(t_ssa),
            dsum=float(dsum),
            wsum=float(fc_wsum),
            t_step=float(fc_t),
            m_used=m,
            err_loc=float(err_loc),
        ), retake

    return step
