"""Milliseconds per solve in the box's per-geometry set-up: the builds
of a geometry's stencil operands, diagonal, dilation and step function
and of its segment function (boxsolver.py ``BoxCmeSolver._functions``
and ``_advance`` on a cache miss) and the grow and shrink of a GROW or
BUDGET event (``_reshape_box``): the program's ``geometry`` span,
inclusive, in a solve of the traced run's draw with the program's spans
recorded and no profiler (cme_bench/spans.py)."""

from cme_bench import spans

UNIT = "ms"


def read(trace):
    rec = spans.program(trace)
    if rec is None or "geometry" not in rec.spans:
        return None
    return 1e3 * rec.spans["geometry"][1]
