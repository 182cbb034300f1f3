"""Host microseconds per replay of an Arnoldi-column CUDA graph
(krylov/graphs.py ``ColumnGraphs._run``: the program's ``replay`` span,
inclusive), in a solve of the traced run's draw with the program's spans
recorded and no profiler (cme_bench/spans.py)."""

from cme_bench import spans

UNIT = "us"


def read(trace):
    rec = spans.program(trace)
    if rec is None or "replay" not in rec.spans:
        return None
    calls, inclusive, _ = rec.spans["replay"]
    return 1e6 * inclusive / calls
