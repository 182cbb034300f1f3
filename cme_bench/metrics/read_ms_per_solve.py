"""Milliseconds per solve in the step controller's device reads
(krylov/stepper.py ``read``: one ``tolist()`` per attempt, which waits
for the work enqueued before it, the exponential among it; the program's
``read`` span, inclusive), in a solve of the traced run's draw with the
program's spans recorded and no profiler (cme_bench/spans.py)."""

from cme_bench import spans

UNIT = "ms"


def read(trace):
    rec = spans.program(trace)
    if rec is None or "read" not in rec.spans:
        return None
    return 1e3 * rec.spans["read"][1]
