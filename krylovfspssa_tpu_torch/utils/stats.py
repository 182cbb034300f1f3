"""Solver observability: per-step records and aggregate counters.

Mirrors the reference's tracing facilities: the per-step PRINT_STATS block
(``reference/src/fsp/KrylovSolver.f90:641-651``) and the IWSP/WSP
statistics outputs (KrylovSolver.f90:554-573), as structured records instead
of stdout prints.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class StepRecord:
    """One accepted (or abandoned) time step."""

    nstep: int
    fsp_size: int
    t_step: float
    t_new: float
    t_now: float
    m: int
    wsum: float
    err_loc: float
    advanced: bool
    expanded: bool
    dropped: int
    #: host wall seconds attributed to this step.  Semantics differ by
    #: path: the non-fused (one-dispatch-per-step) solvers record the
    #: cumulative wall since solve start at the time the step returned;
    #: the fused device loops cannot observe per-step wall and record the
    #: SEGMENT wall amortized over the segment's attempted steps (the
    #: first segment of a geometry additionally carries its jit compile).
    #: Do not compare the two as like-for-like.
    wall_s: float = 0.0

    def format(self) -> str:
        # parity with PRINT_STATS (KrylovSolver.f90:641-651)
        return (
            f"TIMESTEP {self.nstep} ------------------------------\n"
            f" FSP SIZE         = {self.fsp_size}\n"
            f" STEP_SIZE        = {self.t_step:.6g}\n"
            f" NEXT_STEP        = {self.t_new:.6g}\n"
            f" T_NOW            = {self.t_now:.6g}\n"
            f" KRYLOV DIMENSION = {self.m}\n"
            f" WSUM             = {self.wsum:.12f}"
        )


@dataclasses.dataclass
class SolverStats:
    """Aggregate counters (the reference IWSP(1:7) / WSP(1:10))."""

    nmult: int = 0
    nexph: int = 0
    nscale: int = 0
    nstep: int = 0
    nreject: int = 0
    ibrkflag: int = 0
    mbrkdwn: int = 0
    #: failure code (reference IFLAG): 0 ok, 2 = rejection budget exhausted
    iflag: int = 0
    step_min: float = 0.0
    step_max: float = 0.0
    x_error: float = 0.0
    s_error: float = 0.0
    tbrkdwn: float = 0.0
    t_final: float = 0.0
    hump_ratio: float = 0.0
    final_norm_ratio: float = 0.0
    final_fsp_size: int = 0
    n_expansions: int = 0
    n_drops: int = 0
    #: cumulative measured probability-mass loss (step truncation + drops);
    #: drives the float32 FSP criterion and drop budget (StepCarry.spent)
    mass_spent: float = 0.0
    wall_s: float = 0.0
    records: list[StepRecord] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("records")
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
