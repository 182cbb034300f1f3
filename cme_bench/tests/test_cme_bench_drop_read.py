"""CPU tests of ``drop_ms_per_solve`` and ``read_ms_per_solve``: nothing
to read where the recorded solve has no such span, and the span's
inclusive seconds where it has (outside a run: test_cme_bench_spans.py).

    python -m pytest cme_bench/tests -q
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cme_bench import devtrace, harness, spans  # noqa: E402

#: metric -> the program's span it reads
READERS = {"drop_ms_per_solve": "drop", "read_ms_per_solve": "read"}


def _trace():
    return harness.Trace(devtrace.Profile({}, 0, 0.0, 1.0, {}),
                         {"nstep": 3, "nreject": 1}, {})


@pytest.mark.parametrize("name,span", READERS.items())
@pytest.mark.parametrize("recorded,want", [
    ({"drop": (12, 0.25, 0.2), "read": (40, 0.125, 0.125),
      "step": (40, 2.0, 0.5)}, {"drop": 250.0, "read": 125.0}),
    ({"step": (40, 2.0, 0.5), "spmv": (300, 0.1, 0.1)}, {}),
])
def test_reader_takes_the_span_inclusive(monkeypatch, name, span, recorded,
                                         want):
    rec = spans.Spans(recorded, {"nstep": 30, "nreject": 10})
    monkeypatch.setattr(spans, "program", lambda trace: rec)
    got = harness.load_module("metrics", name).read(_trace())
    assert got == (pytest.approx(want[span]) if span in want else None)


@pytest.mark.parametrize("name", READERS)
def test_listed_for_the_toggle_box_cell_only(name):
    # the Goutsias box cell reports no solve_s for these to move
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}[name]
    assert m["workloads"] == ["toggle-customprop.box-t100"]
    assert (m["moves"], m["source"], m["unit"], m["layer"]) == (
        "solve_s", "program_span", "ms", "main loop and step controller")
