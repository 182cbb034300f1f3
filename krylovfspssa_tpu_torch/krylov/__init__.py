from .arnoldi import arnoldi_extend, ArnoldiState
from .stepper import StepCarry, StepResult, make_step_fn, initial_carry

__all__ = [
    "arnoldi_extend",
    "ArnoldiState",
    "StepCarry",
    "StepResult",
    "make_step_fn",
    "initial_carry",
]
