"""Milliseconds per solve in the table's SSA expansion
(statespace/expand.py ``ssa_extend``: the walks on the card and the
merge of the states they visited; the program's ``ssa`` span,
inclusive), in a solve of the traced run's draw with the program's spans
recorded and no profiler (cme_bench/spans.py)."""

from cme_bench import spans

UNIT = "ms"


def read(trace):
    rec = spans.program(trace)
    if rec is None or "ssa" not in rec.spans:
        return None
    return 1e3 * rec.spans["ssa"][1]
