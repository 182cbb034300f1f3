"""Milliseconds per solve in the table's state-space expansion: the SSA
walks and the 1-step rounds with their merges (statespace/expand.py
``ssa_extend`` and ``onestep_extend``, statespace/table.py), timed by the
harness's spans with the card synchronised around each call, in the
traced run's second solve."""

UNIT = "ms"


def read(trace):
    calls = trace.spans.get("ssa_extend", []) + trace.spans.get(
        "onestep_extend", [])
    return 1e3 * sum(calls) if calls else None
