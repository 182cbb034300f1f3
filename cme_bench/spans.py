"""The program's own spans (krylovfspssa_tpu_torch/utils/trace.py) in one
solve of a cell.

The harness's trace profiles solve 1 of the window's draws and times
three program functions from outside.  This module solves the same draw
again with the program recording its spans, unprofiled, so that each
span's host seconds are the real ones (:func:`program`); and, for the
readers of the card's side, once more under torch.profiler, where each
span is a host range ``kfs::<name>`` on the profiler's clock
(:func:`profiled`): per span, the device seconds of the operations
launched inside it and the idle seconds of the device's gaps inside it.

A per-layer reader gets only the harness's ``Trace``, so these find the
cell, model, seed and device of the run in progress in the frame of
``harness.run`` that called the reader, and solve draw 1 as
``harness.trace`` does; each solve runs once per process.  Where the
program has no spans, or no run is in progress, they return None.

Run alone, on the card, it prints one JSON line (``program``, and with
``--profile 1`` the span profile and ``idle_by_span``):

    python3 cme_bench/spans.py --workload <name> --seed <n> [--profile 1]
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cme_bench import devtrace, harness  # noqa: E402

#: the prefix of the program's ranges in a torch.profiler trace
PREFIX = "kfs::"
#: the key of idle time outside every span
OUTSIDE = "(no span)"


@dataclasses.dataclass
class Spans:
    """One recorded solve: ``spans`` {name: (calls, inclusive_s, self_s)}
    and the solve's ``counts`` (harness.run_solve's)."""

    spans: dict
    counts: dict


@dataclasses.dataclass
class SpanProfile:
    """One recorded solve under torch.profiler, per ``kfs::`` name
    (without the prefix): ``calls``, ``device_s`` (device time of the
    operations whose launching runtime call ran with that span the
    innermost) and ``idle_s`` (the device's gaps whose midpoint lies in
    that span as the innermost); ``idle_total_s`` is every gap's time,
    ``device_ranges`` the device events named ``kfs::`` (none expected:
    the program's ranges are host events); ``idle_gaps`` the idle
    seconds by innermost host event of any kind (``devtrace.reduce``'s
    ``idle_by_host``, the spans among them)."""

    calls: dict
    device_s: dict
    idle_s: dict
    idle_total_s: float
    device_ranges: int
    counts: dict
    idle_gaps: dict


def trace_module():
    """The program's span module, or None where the program has none."""
    try:
        from krylovfspssa_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


# ------------------------------------------------------------------ #
#                 the span profile of a list of events               #
# ------------------------------------------------------------------ #

def _launch_points(events):
    """{correlation id: (thread, start)} of the host's runtime calls,
    and of every host event by its own id, for the device operations to
    find the call that launched them."""
    runtime, frontend = {}, {}
    for name, on_device, thread, start, end, corr, linked in events:
        if on_device or corr <= 0:
            continue
        if name.startswith("cu"):
            runtime[corr] = (thread, start)
        else:
            frontend.setdefault(corr, (thread, start))
    return runtime, frontend


def attribute(events):
    """(calls, device_s, idle_s, idle_total_s, device_ranges) of
    ``events``, tuples ``(name, on_device, thread, start_us, end_us,
    correlation_id, linked_correlation_id)``.  A device operation goes to
    the innermost ``kfs::`` span around the runtime call with its
    correlation id (a graph's kernels share their ``cudaGraphLaunch``'s),
    or, without one, around the host event its linked id names; idle
    gaps are found as ``devtrace.reduce`` finds them, on the thread that
    issued most host events, and named by the innermost ``kfs::`` span at
    their midpoint."""
    host = {}
    spans = {}
    dev = []
    device_ranges = 0
    for ev in events:
        name, on_device, thread, start, end = ev[:5]
        if on_device:
            dev.append(ev)
            device_ranges += name.startswith(PREFIX)
            continue
        host.setdefault(thread, []).append((name, start, end))
        if name.startswith(PREFIX):
            spans.setdefault(thread, []).append(
                (name[len(PREFIX):], start, end))
    calls = {}
    for evs in spans.values():
        for name, _, _ in evs:
            calls[name] = calls.get(name, 0) + 1
    runtime, frontend = _launch_points(events)
    device_s = {}
    by_thread = {}
    for name, _, _, start, end, corr, linked in dev:
        at = runtime.get(corr) or frontend.get(linked)
        if at is None:
            key = OUTSIDE
            device_s[key] = device_s.get(key, 0.0) + (end - start) * 1e-6
            continue
        by_thread.setdefault(at[0], []).append((at[1], (end - start) * 1e-6))
    for thread, launches in by_thread.items():
        launches.sort()
        names = devtrace.innermost(spans.get(thread, []),
                                   [p for p, _ in launches])
        for span_name, (_, secs) in zip(names, launches):
            key = span_name or OUTSIDE
            device_s[key] = device_s.get(key, 0.0) + secs
    idle, total = {}, 0.0
    if host:
        main = max(host, key=lambda t: len(host[t]))
        lo = min(ev[1] for ev in host[main])
        hi = max(ev[2] for ev in host[main])
        run_s, run_e = devtrace.busy_runs([ev[3] for ev in dev],
                                          [ev[4] for ev in dev])
        gaps = [(a, b) for a, b in zip([lo, *run_e], [*run_s, hi]) if b > a]
        names = devtrace.innermost(spans.get(main, []),
                                   [(a + b) / 2 for a, b in gaps])
        for span_name, (a, b) in zip(names, gaps):
            key = span_name or OUTSIDE
            secs = float(b - a) * 1e-6
            idle[key] = idle.get(key, 0.0) + secs
            total += secs
    return calls, device_s, idle, total, device_ranges


def profile_events(fn):
    """Run ``fn()`` under torch.profiler on the card; returns (its result,
    the events as :func:`attribute` takes them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = [(e.name, e.device_type == DeviceType.CUDA, e.thread,
               e.time_range.start, e.time_range.end, int(e.id),
               int(getattr(e, "linked_correlation_id", 0) or 0))
              for e in prof.events()]
    return out, events


# ------------------------------------------------------------------ #
#                      the solves of a cell's draw                   #
# ------------------------------------------------------------------ #

_DONE: dict = {}


def _run_in_progress():
    """(cell, model, seed, device, log) of the ``harness.run`` on the
    stack, or None."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code is harness.run.__code__:
            loc = f.f_locals
            return (loc["c"], loc["model"], loc["seed"], loc["device"],
                    loc.get("log", print))
        f = f.f_back
    return None


def record(c, model, seed: int, device: str, log=print):
    """Draw 1 of the cell solved with the program's spans recorded, not
    profiled: a :class:`Spans`, or None."""
    tm = trace_module()
    if tm is None:
        return None
    with tm.recording() as rec:
        sv = harness.run_solve(c, model, seed, 1, device)
    log("recorded " + harness.solve_line(sv))
    return None if sv.fault else Spans(rec.spans, sv.counts)


def record_profiled(c, model, seed: int, device: str, log=print):
    """Draw 1 of the cell solved with the program's spans recorded, under
    torch.profiler: a :class:`SpanProfile`, or None."""
    tm = trace_module()
    if tm is None:
        return None
    with tm.recording():
        sv, events = profile_events(
            lambda: harness.run_solve(c, model, seed, 1, device))
    log("recorded and profiled " + harness.solve_line(sv))
    if sv.fault:
        return None
    p = SpanProfile(*attribute(events), sv.counts, devtrace.reduce(
        [ev[:5] for ev in events], 0.0).idle_by_host)
    log(f"idle by span {devtrace.top(p.idle_s)!r} of {p.idle_total_s!r} s "
        f"idle; {p.device_ranges} device events named {PREFIX}")
    return p


def _once(kind, fn, trace):
    run = _run_in_progress()
    if run is None or trace_module() is None:
        return None
    c, model, seed, device, log = run
    key = (kind, c.name, seed, device)
    if key not in _DONE:
        got = _DONE[key] = fn(c, model, seed, device, log)
        if got is not None:
            same = all(got.counts.get(k) == trace.counts.get(k)
                       for k in ("nstep", "nmult"))
            log(f"the {kind} solve and the traced solve "
                f"{'agree' if same else 'differ'} on nstep and nmult")
    return _DONE[key]


def program(trace):
    """The recorded solve (:class:`Spans`) of the run in progress."""
    return _once("recorded", record, trace)


def profiled(trace):
    """The recorded and profiled solve (:class:`SpanProfile`) of the run
    in progress."""
    return _once("recorded-and-profiled", record_profiled, trace)


# ------------------------------------------------------------------ #
#                                alone                               #
# ------------------------------------------------------------------ #

def main(argv=None) -> int:
    import argparse
    import json

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if trace_module() is None:
        print("the program records no spans", file=sys.stderr)
        return 3
    c = harness.cell(args.workload)
    model = c.config.model()
    log = (lambda s: print(s, file=sys.stderr, flush=True))
    warm = harness.run_solve(c, model, args.seed, 0, "cuda")
    log("warm-up " + harness.solve_line(warm))
    out = {"workload": c.name, "seed": args.seed}
    t0 = time.perf_counter()
    rec = record(c, model, args.seed, "cuda", log)
    out["recorded_wall_s"] = time.perf_counter() - t0
    out["counts"] = rec.counts
    out["program"] = {k: list(v) for k, v in sorted(
        rec.spans.items(), key=lambda kv: -kv[1][1])}
    if args.profile:
        p = record_profiled(c, model, args.seed, "cuda", log)
        out["profile"] = {k: [p.calls.get(k, 0), p.device_s.get(k, 0.0),
                              p.idle_s.get(k, 0.0)]
                          for k in sorted(set(p.calls) | set(p.device_s)
                                          | set(p.idle_s))}
        out["idle_total_s"] = p.idle_total_s
        out["idle_by_span"] = devtrace.top(p.idle_s)
        out["idle_gaps"] = devtrace.top(p.idle_gaps)
        out["device_ranges"] = p.device_ranges
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
