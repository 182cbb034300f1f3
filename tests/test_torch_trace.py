"""The port's host spans (``krylovfspssa_tpu_torch/utils/trace.py``) on the
CPU: the recording's arithmetic, the off path, and short recorded solves
of the box (the CUSTOMPROP toggle) and the table (Goutsias) backends,
whose spans must cover the layers they pass through and leave every
step record as an unrecorded solve makes it.  The column-graph spans
(``replay``, ``capture``) run only on a card."""

import time
from pathlib import Path

import pytest
import torch

from krylovfspssa_tpu_torch import SolverConfig, solve_cme, solve_cme_box
from krylovfspssa_tpu_torch.cli import main as cli_main
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.ops import spmv
from krylovfspssa_tpu_torch.utils import trace

torch.set_num_threads(2)

#: every span the fused box loop passes through on the CPU
BOX_SPANS = {"solve", "segment", "geometry", "step", "arnoldi", "expm",
             "read", "fsp_check", "observe", "drop", "expand_inline"}
#: and the fused table loop
TABLE_SPANS = {"solve", "segment", "step", "arnoldi", "expm", "read",
               "fsp_check", "observe", "ssa", "onestep", "build_operator",
               "spmv"}


def _busy(seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pass


def test_nested_spans_self_and_children_make_inclusive():
    with trace.recording() as rec:
        with trace.span("outer"):
            _busy(0.002)
            for _ in range(3):
                with trace.span("inner"):
                    _busy(0.001)
                    with trace.span("leaf"):
                        _busy(0.001)
    s = rec.spans
    assert s["outer"][0] == 1 and s["inner"][0] == 3 and s["leaf"][0] == 3
    for name in s:
        assert s[name][1] >= s[name][2] > 0
    # self + children = inclusive, at each level
    assert s["outer"][2] + s["inner"][1] == pytest.approx(s["outer"][1],
                                                          abs=1e-12)
    assert s["inner"][2] + s["leaf"][1] == pytest.approx(s["inner"][1],
                                                         abs=1e-12)
    assert s["leaf"][2] == s["leaf"][1]
    assert s["leaf"][1] >= 0.003 and s["outer"][1] >= 0.008


def test_a_name_nested_in_itself_counts_its_time_once():
    with trace.recording() as rec:
        with trace.span("geometry"):
            _busy(0.001)
            with trace.span("geometry"):
                _busy(0.001)
    calls, incl, self_s = rec.spans["geometry"]
    assert calls == 2
    assert self_s == pytest.approx(incl, abs=1e-12)


def test_an_exception_inside_a_span_closes_it():
    with trace.recording() as rec:
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("inner"):
                    raise ValueError("inside")
        with trace.span("after"):
            pass
    s = rec.spans
    assert s["outer"][0] == s["inner"][0] == s["after"][0] == 1
    # "after" opened at the top level: nothing was left on the stack
    assert s["after"][1] == s["after"][2]
    assert s["outer"][1] >= s["inner"][1]


def test_off_path_is_one_shared_object_and_records_nothing():
    a, b = trace.span("step"), trace.span("replay")
    assert a is b
    with trace.span("step") as inner:
        assert inner is a
    with trace.recording() as rec:
        pass
    assert rec.spans == {}
    with trace.span("after_recording"):
        pass
    assert rec.spans == {}
    assert trace.span("x") is a


def test_recording_is_not_reentrant_and_ends_with_its_block():
    with trace.recording():
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
    with pytest.raises(KeyError):
        with trace.recording():
            raise KeyError("x")
    # closed after the exception too: a new recording may start
    with trace.recording() as rec:
        with trace.span("again"):
            pass
    assert rec.spans["again"][0] == 1


def test_spanned_decorator_keeps_the_function():
    @trace.spanned("work")
    def work(x, y=1):
        """Adds."""
        return x + y

    assert work.__name__ == "work" and work.__doc__ == "Adds."
    assert work(2) == 3
    with trace.recording() as rec:
        assert work(2, y=5) == 7
        assert work(1) == 2
    assert rec.spans["work"][0] == 2


def test_a_span_never_synchronises_the_card(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("a span synchronised the card")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    with trace.span("off"):
        pass
    with trace.recording() as rec:
        with trace.span("on"):
            with trace.span("nested"):
                pass
        _box(t=0.5)
    assert rec.spans["on"][0] == 1 and rec.spans["step"][0] > 0


def test_recorded_spans_appear_in_a_profile():
    from torch.profiler import ProfilerActivity, profile

    with trace.recording(), profile(activities=[ProfilerActivity.CPU]) as p:
        with trace.span("outer"):
            torch.ones(4).sum()
    names = {e.name: e for e in p.events()}
    assert "kfs::outer" in names
    assert not names["kfs::outer"].is_user_annotation


# ------------------------------------------------------ recorded solves --


def _box(t=1.0, fused=True):
    return solve_cme_box(tlib.toggle_programmatic_model(), t, [[0, 0]],
                         fsp_tol=1e-4, krylov_tol=1e-10,
                         config=SolverConfig(fused_steps=fused),
                         device="cpu")


def _table(t=4.0, fused=True):
    return solve_cme(tlib.goutsias_model(), t, [[2, 6, 0, 2, 0, 0]],
                     fsp_tol=1e-6, krylov_tol=1e-8,
                     config=SolverConfig(fused_steps=fused, seed=7),
                     device="cpu")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
@pytest.mark.parametrize("backend", ["box", "table"])
def test_recorded_solve_spans_its_layers_and_keeps_its_records(backend,
                                                               fused):
    solve = {"box": _box, "table": _table}[backend]
    plain = solve(fused=fused)
    calls0 = spmv.CALLS
    with trace.recording() as rec:
        res = solve(fused=fused)
    s = rec.spans
    want = {"box": BOX_SPANS, "table": TABLE_SPANS}[backend]
    if not fused:
        # the stepwise loops drop, observe and expand outside the spans
        # of krylov/advance.py
        want = want - {"segment", "observe", "drop", "expand_inline"}
    assert want <= set(s), want - set(s)
    assert s["solve"][0] == 1
    # one call of the step function per record, retakes inside it
    assert s["step"][0] == len(res.stats.records) > 0
    assert res.stats.records == plain.stats.records
    assert (res.stats.nstep, res.stats.nmult) == (plain.stats.nstep,
                                                  plain.stats.nmult)
    if backend == "table":
        assert s["spmv"][0] == spmv.CALLS - calls0 >= res.stats.nmult
    else:
        assert "spmv" not in s and "ssa" not in s
    # the solve holds every other span: nothing is more inclusive
    assert all(v[1] <= s["solve"][1] for v in s.values())
    assert s["step"][1] >= s["arnoldi"][1] + s["expm"][1]


def test_cli_profile_names_the_layers(tmp_path):
    out = tmp_path / "prof"
    assert cli_main(["solve", "bursting_gene", "--t", "1", "--device",
                     "cpu", "--profile", str(out)]) == 0
    traces = list(Path(out).rglob("*.json"))
    assert traces
    text = "".join(p.read_text() for p in traces)
    for name in ("kfs::solve", "kfs::segment", "kfs::step",
                 "kfs::arnoldi"):
        assert name in text, name


@pytest.mark.requires_cuda
def test_column_graph_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("column graphs replay only on a CUDA device")
    with trace.recording() as rec:
        res = solve_cme_box(tlib.toggle_programmatic_model(), 1.0, [[0, 0]],
                            fsp_tol=1e-4, krylov_tol=1e-10)
    s = rec.spans
    assert s["capture"][0] >= 1 and s["replay"][0] >= res.stats.nstep
    # the captures and the replays run inside the Arnoldi extensions
    assert s["arnoldi"][1] >= s["replay"][1] + s["capture"][1]
