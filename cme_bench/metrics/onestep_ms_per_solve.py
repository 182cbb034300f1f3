"""Milliseconds per solve in the table's 1-step expansion rounds
(statespace/expand.py ``onestep_extend``, start-up rounds included; the
program's ``onestep`` span, inclusive), in a solve of the traced run's
draw with the program's spans recorded and no profiler
(cme_bench/spans.py)."""

from cme_bench import spans

UNIT = "ms"


def read(trace):
    rec = spans.program(trace)
    if rec is None or "onestep" not in rec.spans:
        return None
    return 1e3 * rec.spans["onestep"][1]
