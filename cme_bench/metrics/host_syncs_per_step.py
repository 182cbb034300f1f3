"""Host synchronisations per attempted step of the profiled solve: the
runtime's stream, device and event synchronisations and its blocking
copies (cme_bench/devtrace.py ``SYNC_CALLS``) over nstep + nreject.
Layer: the main loop and step controller (boxsolver.py, solver.py,
krylov/advance.py, krylov/stepper.py, krylov/arnoldi.py,
krylov/graphs.py)."""

UNIT = "syncs/step"


def read(trace):
    attempts = trace.counts["nstep"] + trace.counts["nreject"]
    return trace.profile.syncs / attempts if attempts else None
