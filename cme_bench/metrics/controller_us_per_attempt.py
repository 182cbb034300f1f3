"""Host microseconds of the step controller per attempted step: the self
time of the program's ``step`` span (krylov/stepper.py, the step
function with its retakes, less its Arnoldi extensions, exponentials,
device reads, FSP checks and operator summaries, each a span of its
own) over nstep + nreject, in a solve of the traced run's draw with the
program's spans recorded and no profiler (cme_bench/spans.py)."""

from cme_bench import spans

UNIT = "us"


def read(trace):
    rec = spans.program(trace)
    if rec is None or "step" not in rec.spans:
        return None
    n = rec.counts["nstep"] + rec.counts["nreject"]
    return 1e6 * rec.spans["step"][2] / n if n else None
