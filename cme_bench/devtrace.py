"""Reduction of one profiled solve to what the per-layer readers read.

A solve runs under ``torch.profiler`` (host and device activities).  From
its events this module keeps: each device operation's count and time,
the host's synchronising runtime calls, the union of the device's busy
intervals, and the idle gaps between them, each named by the innermost
host operation that was running at the gap's midpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: runtime calls after which the host waits for the device: the three
#: synchronisations and the blocking (not ``Async``) copies.  A
#: device-to-host ``cudaMemcpyAsync`` is followed by one of these, so it
#: is not counted again.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")


@dataclasses.dataclass
class Profile:
    """What one profiled solve left in the trace."""

    #: device operation name -> (executions, seconds)
    device_ops: dict
    #: host synchronisations (``SYNC_CALLS``)
    syncs: int
    #: seconds in which some device operation ran (union of intervals)
    busy_s: float
    #: the profiled solve's wall, host clock, ending in a synchronisation
    window_s: float
    #: host operation name -> idle device seconds while it ran
    idle_by_host: dict


def busy_runs(starts, ends):
    """The union of [starts[i], ends[i]) as disjoint sorted runs."""
    if len(starts) == 0:
        return np.zeros(0), np.zeros(0)
    order = np.argsort(starts, kind="stable")
    s = np.asarray(starts, dtype=np.float64)[order]
    e = np.maximum.accumulate(np.asarray(ends, dtype=np.float64)[order])
    new = np.concatenate([[True], s[1:] > e[:-1]])
    first = np.nonzero(new)[0]
    last = np.concatenate([first[1:] - 1, [len(s) - 1]])
    return s[first], e[last]


def innermost(host, points):
    """For each of ``points`` (sorted), the name of the innermost host
    event (name, start, end) that covers it, or None.  Host events of one
    thread nest, so a sweep with a stack finds it."""
    events = sorted(host, key=lambda ev: (ev[1], -ev[2]))
    out = []
    stack = []
    j = 0
    for p in points:
        while j < len(events) and events[j][1] <= p:
            ev = events[j]
            while stack and stack[-1][2] <= ev[1]:
                stack.pop()
            stack.append(ev)
            j += 1
        while stack and stack[-1][2] <= p:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def reduce(events, window_s: float) -> Profile:
    """Reduce ``events`` (tuples ``(name, on_device, thread, start_us,
    end_us)``) of a solve whose wall was ``window_s``."""
    ops = {}
    dev_s, dev_e = [], []
    host = {}
    syncs = 0
    for name, on_device, thread, start, end in events:
        if on_device:
            n, secs = ops.get(name, (0, 0.0))
            ops[name] = (n + 1, secs + (end - start) * 1e-6)
            dev_s.append(start)
            dev_e.append(end)
        else:
            if name in SYNC_CALLS:
                syncs += 1
            host.setdefault(thread, []).append((name, start, end))
    run_s, run_e = busy_runs(dev_s, dev_e)
    busy = float(np.sum(run_e - run_s)) * 1e-6
    idle = {}
    if host:
        # the thread that issued most events is the solve's
        main = max(host.values(), key=len)
        lo = min(ev[1] for ev in main)
        hi = max(ev[2] for ev in main)
        gap_s = np.concatenate([[lo], run_e])
        gap_e = np.concatenate([run_s, [hi]])
        keep = gap_e > gap_s
        gap_s, gap_e = gap_s[keep], gap_e[keep]
        names = innermost(main, list((gap_s + gap_e) / 2))
        for name, length in zip(names, gap_e - gap_s):
            key = name or "(Python, no operator)"
            idle[key] = idle.get(key, 0.0) + float(length) * 1e-6
    return Profile(ops, syncs, busy, window_s, idle)


def profiled(fn):
    """Run ``fn()`` under torch.profiler on the card; returns (its
    result, the reduced :class:`Profile`)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [(e.name, e.device_type == DeviceType.CUDA, e.thread,
               e.time_range.start, e.time_range.end) for e in prof.events()]
    return out, reduce(events, wall)


def busy_seconds(starts_ns, ends_ns) -> float:
    """Seconds covered by the union of the intervals [starts_ns[i],
    ends_ns[i]) given in nanoseconds."""
    run_s, run_e = busy_runs(starts_ns, ends_ns)
    return float(np.sum(run_e - run_s)) * 1e-9


def device_busy(fn):
    """Run ``fn()`` under torch.profiler tracing the card alone (no host
    operations, so a window of many solves stays cheap to trace); returns
    (its result, the seconds in which some device operation ran: kernels,
    copies and sets, graph replays included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    starts, ends = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            starts.append(e.start_ns())
            ends.append(e.start_ns() + e.duration_ns())
    return out, busy_seconds(starts, ends)


def short(name: str, width: int = 120) -> str:
    """A kernel's name without ``void`` and its parameter list, at most
    ``width`` characters."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for j, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and j > 0 and name[j - 1] != " ":
            name = name[:j]
            break
    return name[:width]


def top(table: dict, n: int = 10):
    """The ``n`` largest entries of {name: seconds} as [[name, seconds]],
    each name shortened."""
    return [[short(k), v]
            for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]
