"""CPU tests of the readers of the program's spans (cme_bench/spans.py and
the metrics that read it): the span profile of a synthetic trace, the
readers with nothing to read, and a traced run on the CPU whose profile
is stubbed (the program's spans are real).

    python -m pytest cme_bench/tests -q
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cme_bench import devtrace, harness, spans  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the metrics that read the program's spans
NEW = ("replay_host_us", "capture_ms_per_solve", "controller_us_per_attempt",
       "geometry_ms_per_solve", "ssa_ms_per_solve", "onestep_ms_per_solve",
       "spmv_us_per_call", "drop_ms_per_solve", "read_ms_per_solve")
CELLS = {"toggle-customprop.box-t100": 2.0, "goutsias6.table-t30": 4.0}

#: (name, on_device, thread, start_us, end_us, correlation, linked)
EVENTS = [
    ("kfs::solve", False, 1, 0.0, 100.0, 1, 0),
    ("kfs::step", False, 1, 10.0, 50.0, 2, 0),
    ("kfs::replay", False, 1, 20.0, 25.0, 3, 0),
    ("cudaGraphLaunch", False, 1, 21.0, 24.0, 101, 3),
    ("kfs::spmv", False, 1, 60.0, 70.0, 4, 0),
    ("aten::mul", False, 1, 61.0, 65.0, 7, 0),
    ("cudaLaunchKernel", False, 1, 62.0, 63.0, 102, 7),
    ("cudaLaunchKernel", False, 1, 80.0, 81.0, 103, 1),
    ("cudaStreamSynchronize", False, 1, 90.0, 92.0, 104, 1),
    ("python", False, 2, 5.0, 6.0, 0, 0),
    # a graph's two kernels, both of the one cudaGraphLaunch
    ("k_graph", True, 7, 30.0, 34.0, 101, 3),
    ("k_graph", True, 7, 31.0, 36.0, 101, 3),
    ("k_mul", True, 7, 64.0, 66.0, 102, 7),
    ("k_late", True, 7, 82.0, 90.0, 103, 1),
    # no runtime call with its id: found by its linked host event
    ("k_linked", True, 7, 92.0, 93.0, 999, 7),
]


def test_span_profile_of_a_synthetic_trace():
    calls, device_s, idle, total, ranges = spans.attribute(EVENTS)
    assert calls == {"solve": 1, "step": 1, "replay": 1, "spmv": 1}
    assert ranges == 0
    us = pytest.approx
    assert device_s["replay"] == us(9e-6)  # both graph kernels
    assert device_s["spmv"] == us(3e-6)  # k_mul and k_linked
    assert device_s["solve"] == us(8e-6)
    assert set(device_s) == {"replay", "spmv", "solve"}
    # gaps [0, 30) at 15 and [36, 64) at 50 (step closes at 50); [66, 82),
    # [90, 92) and [93, 100) in the solve alone
    assert idle["step"] == us(30e-6)
    assert idle["solve"] == us(28e-6 + 16e-6 + 2e-6 + 7e-6)
    assert total == us(83e-6) == us(sum(idle.values()))


def test_span_ranges_leave_the_device_reduction_unchanged():
    plain = [ev[:5] for ev in EVENTS if not ev[0].startswith("kfs::")]
    with_spans = [ev[:5] for ev in EVENTS]
    a, b = devtrace.reduce(plain, 1e-4), devtrace.reduce(with_spans, 1e-4)
    assert a.device_ops == b.device_ops
    assert (a.syncs, a.busy_s, a.window_s) == (b.syncs, b.busy_s, b.window_s)
    assert a.syncs == 1


def test_device_events_named_like_a_span_are_counted():
    ev = EVENTS + [("kfs::spmv", True, 7, 60.0, 61.0, 0, 0)]
    assert spans.attribute(ev)[4] == 1


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_outside_a_run(name):
    p = devtrace.Profile({}, 0, 0.0, 1.0, {})
    tr = harness.Trace(p, {"nstep": 3, "nreject": 1}, {})
    reader = harness.load_module("metrics", name)
    assert reader.read(tr) is None


def _traced_cpu_run(name, monkeypatch):
    """A traced run of the cell at a short horizon on the CPU: the
    harness's profiled and spanned solves are replaced by one plain solve
    (torch.profiler's device side needs a card), and the span profile
    has only the host's events."""
    c = harness.cell(name)
    c = dataclasses.replace(c, traffic=dict(c.traffic, t_out=CELLS[name]))

    def fake_trace(c, model, seed, device, log=print):
        sv = harness.run_solve(c, model, seed, 1, device)
        return harness.Trace(devtrace.Profile({}, 0, 0.0, 1.0, {}),
                             sv.counts, {})

    def host_profile(fn):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
        return out, [(e.name, False, e.thread, e.time_range.start,
                      e.time_range.end, int(e.id), 0)
                     for e in prof.events()]

    monkeypatch.setattr(harness, "trace", fake_trace)
    monkeypatch.setattr(spans, "profile_events", host_profile)
    monkeypatch.setattr(spans, "_DONE", {})
    lines = []
    r = harness.run(c, 2 ** 31 + 5, 0.5, True, time.perf_counter(),
                    device="cpu", log=lines.append)
    return c, r, lines


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_program_spans(name, monkeypatch):
    c, r, lines = _traced_cpu_run(name, monkeypatch)
    assert r["correct"], r["checks"]
    listed = {m["name"] for m in c.per_layer} & set(NEW)
    host = listed - {"spmv_us_per_call", "replay_host_us",
                     "capture_ms_per_solve"}  # graphs replay on a card
    assert host
    for m in host:
        v = r["metrics"][m]["value"]
        assert np.isfinite(v) and v > 0, (m, v)
    # on the CPU the SpMV's operations launch nothing on a device
    assert "spmv_us_per_call" not in r["metrics"]
    assert any("agree on nstep and nmult" in s for s in lines)
    # each extra solve runs once, for every reader of it
    assert sum(s.startswith("recorded solve") for s in lines) == 1


def test_a_program_without_spans_gives_nothing(monkeypatch):
    monkeypatch.setattr(spans, "trace_module", lambda: None)
    c, r, lines = _traced_cpu_run("goutsias6.table-t30", monkeypatch)
    assert not set(NEW) & set(r["metrics"])
    assert not any(s.startswith("recorded") for s in lines)


def test_new_metrics_are_listed_for_the_cells_that_read_them():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["moves"] == "solve_s" and m["workloads"]
        assert m["source"] in ("program_span", "device_trace")
