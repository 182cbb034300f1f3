"""Device microseconds per call of the table's gather-ELL SpMV
(ops/spmv.py ``spmv``): the device time of the operations launched inside
the program's ``spmv`` span over its calls, in a solve of the traced
run's draw with the program's spans recorded under torch.profiler
(cme_bench/spans.py).  A solve that makes no SpMV call (the box) is not
profiled for it."""

from cme_bench import spans

UNIT = "us"


def read(trace):
    rec = spans.program(trace)
    if rec is None or "spmv" not in rec.spans:
        return None
    p = spans.profiled(trace)
    if p is None or not p.calls.get("spmv") or "spmv" not in p.device_s:
        return None
    return 1e6 * p.device_s["spmv"] / p.calls["spmv"]
