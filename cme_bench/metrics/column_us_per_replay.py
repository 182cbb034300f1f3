"""Device microseconds per replay of an Arnoldi-column CUDA graph
(krylov/graphs.py ``ColumnGraphs._run``): the device time of the
operations launched inside the program's ``replay`` span over its calls,
in a solve of the traced run's draw with the program's spans recorded
under torch.profiler (cme_bench/spans.py).  A graph's kernels share its
launch's correlation id, so this is a column's whole device time, its
matvec included (the avnorm replays are among the calls).  A solve that
replays no graph (the table) is not profiled for it."""

from cme_bench import spans

UNIT = "us"


def read(trace):
    rec = spans.program(trace)
    if rec is None or "replay" not in rec.spans:
        return None
    p = spans.profiled(trace)
    if p is None or not p.calls.get("replay") or "replay" not in p.device_s:
        return None
    return 1e6 * p.device_s["replay"] / p.calls["replay"]
