"""CPU tests of ``column_us_per_replay``: nothing to read outside a run or
where no graph replays, and the device time inside ``replay`` over its
calls where the span profile has them.

    python -m pytest cme_bench/tests -q
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cme_bench import devtrace, harness, spans  # noqa: E402

NAME = "column_us_per_replay"


def _trace():
    return harness.Trace(devtrace.Profile({}, 0, 0.0, 1.0, {}),
                         {"nstep": 3, "nreject": 1}, {})


def test_reader_finds_nothing_outside_a_run():
    assert harness.load_module("metrics", NAME).read(_trace()) is None


@pytest.mark.parametrize("recorded,calls,device_s,want", [
    ({"replay": (4, 1e-3, 1e-3)}, {"replay": 4}, {"replay": 40e-6}, 10.0),
    ({"spmv": (4, 1e-3, 1e-3)}, {"spmv": 4}, {"spmv": 40e-6}, None),
    ({"replay": (4, 1e-3, 1e-3)}, {}, {}, None),
])
def test_reader_divides_replay_device_time_by_calls(monkeypatch, recorded,
                                                    calls, device_s, want):
    rec = spans.Spans(recorded, {})
    prof = spans.SpanProfile(calls, device_s, {}, 0.0, 0, {}, {})
    monkeypatch.setattr(spans, "program", lambda trace: rec)
    monkeypatch.setattr(spans, "profiled", lambda trace: prof)
    got = harness.load_module("metrics", NAME).read(_trace())
    assert got == (want if want is None else pytest.approx(want))


def test_listed_for_the_box_cell_only():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert m["workloads"] == ["toggle-customprop.box-t100"]
    assert (m["moves"], m["source"], m["unit"]) == ("solve_s", "device_trace",
                                                    "us")
