"""Milliseconds per solve in the box loop's drop (krylov/advance.py
``drop_inline``: the mask arithmetic of DROP_STATES with its anti-thrash
gate, enqueued on the card and read back; the program's ``drop`` span,
inclusive), in a solve of the traced run's draw with the program's spans
recorded and no profiler (cme_bench/spans.py)."""

from cme_bench import spans

UNIT = "ms"


def read(trace):
    rec = spans.program(trace)
    if rec is None or "drop" not in rec.spans:
        return None
    return 1e3 * rec.spans["drop"][1]
