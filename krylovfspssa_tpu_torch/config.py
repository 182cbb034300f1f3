"""Solver configuration (PyTorch port; field names and defaults are the
JAX package's ``krylovfspssa_tpu/config.py``).

Every algorithm constant of the reference Krylov-FSP-SSA implementation is
exposed here with its reference default (constants documented in
``reference/src/fsp/KrylovSolver.f90:47,77-87,136-137,173,194`` and
``reference/src/state_space/StateSpace.f90:10-11``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """All tunables of the Krylov-FSP-SSA algorithm.

    Defaults replicate the reference Fortran behaviour so that solutions agree
    within the FSP tolerance.

    The PyTorch port accepts every field of the JAX package's config.  The
    box solve of this port reads the Krylov, step-control, FSP, box and
    numerics fields, and the main-loop fields ``fused_steps``,
    ``max_steps_per_call`` and ``box_shrink_fraction`` (boxsolver.py).
    Under a mesh the box solve reads ``use_halo`` (False: the halos are
    cut from an all_gather of the vector instead of swapped with the
    neighbours; the same hand-written kernel runs either way).
    The table solve (solver.py) reads the same Krylov, step-control, FSP
    and main-loop fields and ``max_states``, ``init_capacity``,
    ``ssa_max_steps``, ``seed``, ``table_operator`` and
    ``pencil_lane_species`` (the pencil operator, ops/pencil.py).  Both
    accept and ignore: ``use_pallas`` (TPU kernel pins; on CUDA the
    hand-written stencil kernel is always taken),
    ``pencil_max_overcoverage`` (read by the JAX package's "auto" on TPU
    only), ``capacity_growth`` (buckets double, as in the JAX package),
    ``warm_next_bucket`` (a background compile of the JAX package) and
    ``debug_nans``.
    """

    # ---- Krylov subspace bounds (KrylovSolver.f90:47) -------------------
    m_min: int = 10
    m_max: int = 100
    #: incomplete-orthogonalization window (KrylovSolver.f90:136-137)
    qiop: int = 2

    # ---- step control (KrylovSolver.f90:77-87) --------------------------
    #: local truncation error safety factor DELTA
    delta: float = 1.2
    #: stepsize shrinking factor GAMMA
    gamma: float = 0.9
    #: diagonal Pade degree for the small expm (0 would select Chebyshev)
    ideg: int = 6
    #: max number of integration steps; 0 = unlimited
    mxstep: int = 0
    #: max rejections per step; 0 = unlimited
    mxreject: int = 0
    #: happy-breakdown tolerance (KrylovSolver.f90:173)
    break_tol: float = 1.0e-7
    #: assumed operator norm (KrylovSolver.f90:129)
    anorm: float = 1.0

    # ---- FSP control ----------------------------------------------------
    #: initial drop threshold (KrylovSolver.f90:194, StateSpace.f90:416)
    droptol_start: float = 1.0e-8
    #: states whose inflow (A w)_i exceeds this are never dropped
    #: (StateSpace.f90:491)
    inflow_guard: float = 1.0e-8
    #: compaction only happens when more than this fraction is droppable
    #: (StateSpace.f90:497)
    drop_fraction: float = 0.1
    #: anti-thrash gate on the table backend's inline drop (no reference
    #: counterpart — a fix, not a port): only commit a drop when the drop
    #: set's total inflow rate sum_i (A w)_i stays below this fraction of
    #: the FSP budget rate fsp_tol/t_out.  The reference's PER-STATE
    #: inflow guard (StateSpace.f90:486-495, 1e-8 each) cannot bound the
    #: SUM: on toggle t=1000 the ~330-state tail shell it allowed to drop
    #: carried enough combined inflow that the next step always failed
    #: the FSP criterion and SSA re-added the same shell — a drop/expand
    #: limit cycle (4160 steps / 2084 expansions vs 64 steps without).
    #: Skipping such drops is strictly conservative: kept states only
    #: reduce truncation error.
    drop_rate_frac: float = 0.5
    #: memory-pressure escape for the gate above: once the active state
    #: count reaches this fraction of max_states, commit qualifying drops
    #: regardless of their gross leak rate (running out of state budget
    #: is worse than an extra expansion epoch)
    drop_pressure_frac: float = 0.5
    #: consecutive FSP rejections before abandoning the step for SSA
    #: expansion (KrylovSolver.f90:466)
    max_fsp_rejects: int = 5
    #: number of 1-step reachability expansions at start-up
    #: (KrylovSolver.f90:132-134)
    init_onestep_expansions: int = 5

    # ---- state space ----------------------------------------------------
    #: hard cap on FSP size (reference NMAX, StateSpace.f90:10)
    max_states: int = 6_291_469
    #: per-species molecule-count cap (reference MAXNUMBERMOLECULES,
    #: StateSpace.f90:11). The actual per-model key radix may be reduced so
    #: that packed keys fit in int64 (see statespace/encoding.py).
    max_molecules: int = 10_000
    #: initial padded capacity for device arrays
    init_capacity: int = 1 << 12
    #: capacity growth factor when the state set outgrows its bucket
    capacity_growth: int = 2
    #: table-backend operator representation: "ell" = the reference-format
    #: gather-ELL (ops/operator.py; XLA:TPU serializes its per-element
    #: gathers to ~30 ns each — fine for small FSPs, ~160 ms/matvec at
    #: 600k states), "pencil" = the support-adapted row-gather +
    #: lane-shift form (ops/pencil.py; no per-element gathers, ~3x cell
    #: padding).  "auto" = pencil on TPU backends when the mesh is unset
    #: and the layout stays efficient, else ell: in this port (CPU and
    #: CUDA) always ell.  Any other value builds the pencil, except under a
    #: mesh, as in the JAX package.
    table_operator: str = "auto"
    #: lane species of the pencil layout (None = per-solve argmax extent)
    pencil_lane_species: int | None = None
    #: "auto" falls back to ell when pencil cell over-coverage exceeds
    #: this factor (degenerate supports where lane runs are tiny)
    pencil_max_overcoverage: float = 8.0

    # ---- box backend ----------------------------------------------------
    #: run the box backend's main loop in segments (krylov/advance.py:
    #: the host re-enters on growth, budget, completion or failure, and
    #: shrinks loose axes); False = the stepwise loop, one step at a time
    fused_steps: bool = True
    #: stencil SpMV kernel selection: "auto" uses the hand-tiled Pallas
    #: kernel (ops/pallas_stencil.py) when dtype is float32, the backend is
    #: a TPU, and the box geometry qualifies; "never"/"always" force it
    #: off/on; "v6" opts real-TPU runs into the v6 scalarized-row-factor
    #: kernel (interpret-validated; blocked on a remote Mosaic lowering
    #: failure as of round 4 — see BASELINE.md "Round-4 kernel status")
    use_pallas: str = "auto"
    #: use the explicit ppermute halo-exchange SpMV (ops/halo.py) for
    #: mesh-sharded solves when the model/geometry qualify; False falls
    #: back to GSPMD's generic partitioning of the stencil
    use_halo: bool = True
    #: minimum rounds of mask dilation per expansion event in the box
    #: backend (the SSA+1-step analog; each round activates the 1-step
    #: reachable shell)
    box_expand_rounds: int = 4
    #: cap on the *event-scaled* dilation count per expansion.  The
    #: reference's SSA walks explore ~diag(x)*t_ssa reaction events ahead
    #: (StateSpace.f90:577-588); the box backend matches that reach with
    #: K = ceil(lam*t_ssa + 3*sqrt(lam*t_ssa)) + 1 dilation rounds (a
    #: Poisson tail quantile), lam = max total propensity over
    #: mass-supported cells, clipped to [box_expand_rounds, this].
    box_expand_rounds_max: int = 256
    #: hard cap on box volume (cells); growth beyond this raises.  The
    #: Krylov basis holds (m_max+2) box-sized vectors, so float64 at the
    #: default m_max=100 needs vol*816 bytes of HBM (8 GB at 2^23).
    max_box_volume: int = 1 << 23
    #: shrink a box axis (halve its extent) when the active cells occupy
    #: at most this fraction of it; 0 disables shrinking.  Checked on host
    #: re-entries; hysteresis below the 1/2 growth threshold avoids churn.
    box_shrink_fraction: float = 0.375
    #: smallest per-axis log2 extent
    box_min_log2: int = 2

    # ---- SSA expansion --------------------------------------------------
    #: max SSA steps per walk in the batched device SSA extender; the
    #: reference walks until the local time budget is exhausted
    #: (StateSpace.f90:571-629) — a bounded walk plus the FSP criterion
    #: gives the same safety guarantee.
    ssa_max_steps: int = 100
    #: RNG seed for SSA walks
    seed: int = 0

    #: HBM budget for the Krylov basis V ((m_max+2) box-volume vectors).
    #: Geometries where the full basis would exceed this get m_max clamped
    #: to fit (the Niesen-Wright adaptivity simply works under the lower
    #: cap).  Without it, a float64 solve on a 2^23-cell box allocates
    #: 102 * 8M * 8B = 6.8 GB for V alone and OOM-crashes a 16 GB chip
    #: inside the fused loop.  0 disables the clamp.  The round-2 default
    #: (4 GiB) still crashed the TPU worker on the Goutsias t=300 float64
    #: run once the box grew to 2^23 cells (basis + loop temporaries +
    #: stencil windows exceed the worker's budget well before V alone
    #: does), hence 2 GiB; ``max_basis_frac`` additionally bounds the
    #: basis to a fraction of the device's reported memory when the
    #: backend exposes ``memory_stats``.
    max_basis_bytes: int = 2 << 30
    #: cap the basis at this fraction of the device's ``bytes_limit``
    #: (ignored when the backend reports no memory stats)
    max_basis_frac: float = 0.2

    # ---- numerics -------------------------------------------------------
    #: probability vector / Krylov basis dtype: "float64", "float32", or
    #: "auto" (the default) — float32 on accelerator backends (where it
    #: enables the hand-tiled Pallas stencil kernel and native-rate VPU
    #: math; f64 is emulated and ~5x slower), float64 on CPU.  The FSP
    #: mass criterion, the small-Hessenberg exponential, and all norm /
    #: sum reductions run in float64 in EVERY mode, so the acceptance
    #: logic matches the reference bit-for-bit; validated by the
    #: f32-vs-f64 agreement tests (tests/test_box.py).
    dtype: str = "auto"
    #: Per-step FSP-criterion noise floor in float32 mode, in f32 ULP
    #: (~1.19e-7).  A float32 probability vector's total mass carries
    #: O(ULP) representation noise that random-walks across steps, so the
    #: reference's *absolute* criterion ``wsum >= 1 - fsptol*(t+tau)/t_out``
    #: eventually rejects forever on drift.  Float32 mode instead charges
    #: each step's measured loss (start mass - end mass; the drift cancels
    #: in the difference) against the remaining cumulative allowance
    #: ``bound(t+tau) - spent`` plus this floor, where ``spent`` is the
    #: cumulative measured loss (StepCarry.spent) — identical to the
    #: reference criterion in exact arithmetic, but drift-free.  The
    #: floor must exceed the per-attempt mass noise of an f32 Krylov
    #: step (~m_used*eps32, i.e. a few e-6 — it scales with the AXPY
    #: chain depth per element, not with the mask size) or early steps
    #: reject on noise, expand the mask, amplify the noise, and spiral
    #: to FSP overflow.  The floor is RESERVED out of the user's budget
    #: (the pro-rata bound runs on ``fsp_tol - floor``), so the final
    #: certified loss is at most ``fsp_tol`` exactly as in float64; the
    #: price is that float32 refuses tolerances without headroom above
    #: the floor (see :func:`resolve_solve_dtype`).  Ignored in float64
    #: mode.
    f32_criterion_floor_ulps: float = 64.0
    #: minimum ratio of ``fsp_tol`` to the f32 criterion floor for a
    #: float32 solve to be certifiable.  Below ``mult*floor`` (~1.5e-5 at
    #: the defaults) the reserved budget leaves no room to integrate:
    #: ``dtype="auto"`` silently falls back to float64, explicit
    #: ``dtype="float32"`` raises (the FSP bound is an absolute guarantee,
    #: KrylovSolver.f90:442-458 — never weaken it silently).
    f32_min_fsp_tol_mult: float = 2.0

    def f32_criterion_floor(self) -> float:
        """The f32 per-step noise floor in absolute probability mass."""
        return self.f32_criterion_floor_ulps * 1.1920928955078125e-07

    def f32_min_fsp_tol(self) -> float:
        """Tightest fsp_tol a float32 solve will certify."""
        return self.f32_min_fsp_tol_mult * self.f32_criterion_floor()

    def f32_min_krylov_tol(self) -> float:
        """Tightest krylov_tol float32 can honestly pursue: 32 x eps32
        (~3.8e-6).  A float32 Krylov basis carries O(eps32) representation
        noise per component, so the local-error estimate floors near eps32
        regardless of tau; a tighter target makes the Niesen-Wright
        controller shrink tau against that floor without gaining accuracy
        (round-3 finding: toggle t=1000 took 2846 steps at krylov_tol
        1e-10 vs 64 in float64; at 4e-6 it takes 742).  The floor is NOT
        the reference's sqrt(eps) rule (KrylovSolver.f90:171) evaluated at
        eps32: sqrt(eps32) ~ 3.5e-4 was measured to overshoot — the
        controller then picks steps so large that the per-step SSA
        expansion horizon (t_ssa ~ t_new, KrylovSolver.f90:520-521) grows
        the state space past its volume cap before the FSP criterion can
        settle (box-overflow on the toggle t=1000 run)."""
        return 32.0 * 1.1920928955078125e-07

    def resolved_dtype(self, device="cuda") -> str:
        """Concrete dtype for a solve on ``device`` (float64 on the CPU,
        float32 on any other device under ``dtype="auto"``)."""
        if self.dtype != "auto":
            return self.dtype
        return "float64" if _backend(device) == "cpu" else "float32"

    # ---- observability --------------------------------------------------
    #: 0 = silent, 1 = per-step stats (reference ITRACE/PRINT_STATS)
    verbosity: int = 0
    #: enable jax_debug_nans for the solve — every NaN-producing op raises
    #: immediately instead of flowing into the ISNAN tau/5 retry
    #: (KrylovSolver.f90:307); off by default for parity with the
    #: reference's silent-retry behaviour
    debug_nans: bool = False
    #: take at most this many attempted steps in one fused segment before
    #: returning to the host (a BUDGET event: shrink check, checkpoint)
    max_steps_per_call: int = 1_000
    #: pre-compile the table backend's next capacity bucket in a daemon
    #: thread while stepping.  OFF by default: on the remote TPU backend a
    #: concurrent background compile was observed to corrupt in-flight
    #: execution (see CmeSolver._warm_next_bucket).
    warm_next_bucket: bool = False


DEFAULT_CONFIG = SolverConfig()


def _backend(device) -> str:
    """Backend name of a torch device spec (``"cuda:0"`` -> ``"cuda"``)."""
    return str(device).split(":", 1)[0]


def resolve_solve_dtype(
    config: SolverConfig,
    fsp_tol: float,
    backend: str = "cuda",
    krylov_tol: float | None = None,
) -> str:
    """Concrete solve dtype honoring the float32 tolerance contract.

    Float32 mode certifies the FSP bound only down to
    ``config.f32_min_fsp_tol()`` (~1.5e-5 at the defaults): below that the
    reserved per-step noise floor leaves no budget to integrate.  The
    reference treats the FSP bound as absolute (KrylovSolver.f90:442-458),
    so a tighter request must never be silently weakened:

      * ``dtype="auto"`` (the production default) falls back to float64,
      * explicit ``dtype="float32"`` raises ``ValueError``.

    ``krylov_tol`` below ``config.f32_min_krylov_tol()`` (~3.5e-4) also
    demotes ``"auto"`` to float64: float32 cannot pursue such a local
    error target (the estimate floors at basis noise and the controller
    responds with a ~40x step-count explosion — BASELINE.md round-3).
    Under explicit ``dtype="float32"`` the solvers instead CLAMP
    krylov_tol to the floor, with a warning (the reference's own
    below-eps tolerance floor, KrylovSolver.f90:171, applied at the
    working precision).

    ``backend`` is the solve's device (``"cpu"``, ``"cuda"``, ``"cuda:1"``);
    every device other than the CPU counts as an accelerator, as every
    backend other than ``"cpu"`` does in the JAX package.
    """
    dt = config.dtype
    if dt == "auto":
        dt = "float64" if _backend(backend) == "cpu" else "float32"
    if dt == "float32" and fsp_tol < config.f32_min_fsp_tol():
        if config.dtype == "auto":
            return "float64"
        raise ValueError(
            f"fsp_tol={fsp_tol:g} is below the float32 certifiable minimum "
            f"{config.f32_min_fsp_tol():g} (= f32_min_fsp_tol_mult x the "
            "f32 criterion noise floor); use dtype='float64' or "
            "dtype='auto', or loosen fsp_tol"
        )
    if (
        dt == "float32"
        and config.dtype == "auto"
        and krylov_tol is not None
        and krylov_tol < config.f32_min_krylov_tol()
    ):
        return "float64"
    return dt


def clamp_f32_krylov_tol(config: SolverConfig, krytol: float) -> float:
    """Floor krylov_tol at the float32-achievable minimum (explicit
    float32 mode only), with a loud warning — see
    :meth:`SolverConfig.f32_min_krylov_tol`."""
    floor = config.f32_min_krylov_tol()
    if krytol < floor:
        import warnings

        warnings.warn(
            f"krylov_tol={krytol:g} is below the float32-achievable floor; "
            f"clamped to {floor:g} (32 x eps32 — the f32 basis noise "
            "scale; see SolverConfig.f32_min_krylov_tol).  Use "
            "dtype='float64' for tighter local error.",
            stacklevel=3,
        )
        return floor
    return krytol
