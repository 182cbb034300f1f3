"""Milliseconds per solve in the captures of the Arnoldi-column CUDA
graphs (krylov/graphs.py ``ColumnGraphs._capture``, each geometry's eager
warm-up column included: the program's ``capture`` span, inclusive), in
a solve of the traced run's draw with the program's spans recorded and
no profiler (cme_bench/spans.py)."""

from cme_bench import spans

UNIT = "ms"


def read(trace):
    rec = spans.program(trace)
    if rec is None or "capture" not in rec.spans:
        return None
    return 1e3 * rec.spans["capture"][1]
