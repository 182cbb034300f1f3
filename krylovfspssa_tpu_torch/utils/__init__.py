from .stats import StepRecord, SolverStats

__all__ = ["StepRecord", "SolverStats"]
