"""Milliseconds per solve in the table's operator builds
(ops/operator.py ``build_operator``), timed by the harness's spans with
the card synchronised around each call, in the traced run's second
solve."""

UNIT = "ms"


def read(trace):
    calls = trace.spans.get("build_operator", [])
    return 1e3 * sum(calls) if calls else None
