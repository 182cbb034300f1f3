#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``krylovfspssa_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written stencil kernel from ``krylovfspssa_tpu_torch/csrc``
with nvcc, holds it against its plain PyTorch version on the card, and
drives the port's main path — the box-backend CME solve — through
``solve_cme_box``/``BoxCmeSolver`` on ``cuda``:

  1. environment: card name and power limit, torch/CUDA versions, kernel
     build time;
  2. kernel vs plain version at three box geometries (the 2^22-cell
     Goutsias box, a toggle box, a box smaller than one thread block) in
     float64 and float32, with timings; plus a small toggle solve on the
     card against the same solve on the CPU;
  3. the reference driver TestSolverFromFile: toggle, t=1000, fsp_tol 1e-4,
     krylov_tol 1e-10 (float64);
  4. real size: the Goutsias example (reference examples/transcr6d.f90) at
     its reference tolerances to t=10, which ends in a 2^22-cell box.

Each phase prints its own lines with its wall time.  Any failure raises
and exits non-zero.  The last lines are a JSON record of the kernels, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

#: counts the JAX package's stepwise box solve reached on this scenario
#: (Goutsias, t=10, fsp_tol 1e-6, krylov_tol 1e-8, float64, on a CPU);
#: printed beside the port's for comparison, not asserted
JAX_GOUTSIAS_T10 = dict(box_volume=1 << 22, box_shape=(32, 4, 4, 64, 32, 4),
                        fsp_size=57023, nstep=8, nmult=175, nreject=6,
                        wsum=0.99999991)

F64_RTOL = 1e-12
F32_RTOL = 1e-5


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def _grown(model, x0, targets):
    from krylovfspssa_tpu_torch.boxspace.box import BoxSpace

    box = BoxSpace.for_model(model.stoichiometry, x0)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    return box


def _time_ms(fn, *args, warmup=3, reps=30) -> float:
    """Median milliseconds per call over ``reps`` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def phase_env():
    import torch

    from krylovfspssa_tpu_torch.ops import stencil_cuda

    t0 = time.perf_counter()
    smi = _smi()
    print(f"[env] nvidia-smi: {smi}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    info = stencil_cuda.build()
    print(f"[env] box_stencil built in {info.seconds:.2f} s -> {info.path}")
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[env]   {line.strip()}")
    print(f"[env] wall {time.perf_counter() - t0:.2f} s")
    return smi


def phase_kernels():
    """Kernel vs plain version on the card; returns the flagship f64 row."""
    import torch

    from krylovfspssa_tpu_torch.models.library import (
        goutsias_model,
        repressilator_model,
        toggle_file_model,
    )
    from krylovfspssa_tpu_torch.ops.stencil import make_stencil_matvec
    from krylovfspssa_tpu_torch.ops.stencil_cuda import (
        make_box_stencil_matvec,
    )

    t0 = time.perf_counter()
    cases = [
        ("goutsias-2^22", goutsias_model(), [[2, 6, 0, 2, 0, 0]],
         [64, 64, 16, 4, 4, 4]),
        ("toggle-512x512", toggle_file_model(), [[0, 0]], [512, 512]),
        ("repressilator-128", repressilator_model(), [[0, 0, 0]], [4, 4, 8]),
    ]
    flagship = None
    for name, model, x0, targets in cases:
        box = _grown(model, x0, targets)
        for dt, rtol in ((torch.float64, F64_RTOL), (torch.float32, F32_RTOL)):
            rng = np.random.default_rng(0)
            mask = torch.as_tensor(rng.random(box.volume) < 0.6,
                                   device="cuda")
            x = torch.as_tensor(rng.random(box.volume), dtype=dt,
                                device="cuda")
            kern = make_box_stencil_matvec(model, box, dt, "cuda")
            plain = make_stencil_matvec(model, box, dt, "cuda")
            y_k = kern(mask, x)
            y_p = plain(mask, x)
            torch.cuda.synchronize()
            err = float(torch.max(torch.abs(y_k - y_p)))
            scale = float(torch.max(torch.abs(y_p)))
            ms_k = _time_ms(kern, mask, x)
            ms_p = _time_ms(plain, mask, x)
            itemsize = x.element_size()
            # compulsory traffic: x, D, y words and the mask byte per cell
            gbytes = box.volume * (3 * itemsize + 1) / 1e9
            print(f"[kernels] {name} {str(dt)[6:]} vol={box.volume} "
                  f"max_abs_err={err:.3e} (limit {rtol:g} x {scale:.3e}) "
                  f"kernel {ms_k * 1e3:.1f} us ({gbytes / ms_k * 1e3:.0f} "
                  f"GB/s)  plain {ms_p * 1e3:.1f} us "
                  f"({gbytes / ms_p * 1e3:.0f} GB/s)")
            if not err <= rtol * scale:
                raise AssertionError(
                    f"{name} {dt}: kernel disagrees with the plain version "
                    f"({err:.3e} > {rtol:g} x {scale:.3e})"
                )
            if flagship is None:
                flagship = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p)
    print(f"[kernels] wall {time.perf_counter() - t0:.2f} s")
    return flagship


def phase_small_solve():
    """A small solve on the card against the same solve on the CPU (the
    plain-version reference): within the FSP tolerance of each other."""
    from krylovfspssa_tpu_torch import solve_cme_box
    from krylovfspssa_tpu_torch.models.library import toggle_file_model

    t0 = time.perf_counter()
    kw = dict(fsp_tol=1e-4, krylov_tol=1e-8)
    rg = solve_cme_box(toggle_file_model(), 1.0, [[0, 0]], device="cuda",
                       **kw)
    rc = solve_cme_box(toggle_file_model(), 1.0, [[0, 0]], device="cpu",
                       **kw)
    pg = {tuple(s): p for s, p in zip(rg.states, rg.probabilities)}
    pc = {tuple(s): p for s, p in zip(rc.states, rc.probabilities)}
    l1 = sum(abs(pg.get(k, 0.0) - pc.get(k, 0.0)) for k in set(pg) | set(pc))
    print(f"[small] toggle t=1 cuda vs cpu: L1={l1:.3e} "
          f"nstep {rg.stats.nstep}/{rc.stats.nstep} "
          f"nmult {rg.stats.nmult}/{rc.stats.nmult} "
          f"wsum {rg.wsum:.10f}/{rc.wsum:.10f} "
          f"wall {time.perf_counter() - t0:.2f} s")
    if not (np.all(np.isfinite(rg.probabilities)) and l1 <= 2 * kw["fsp_tol"]):
        raise AssertionError(f"cuda and cpu solves differ: L1={l1:.3e}")


def _solve(model, t, x0, fsp_tol, krylov_tol):
    import torch

    from krylovfspssa_tpu_torch import BoxCmeSolver
    from krylovfspssa_tpu_torch.ops import stencil_cuda

    solver = BoxCmeSolver(model, device="cuda")
    before = stencil_cuda.LAUNCHES
    t0 = time.perf_counter()
    res = solver.solve(t, x0, fsp_tol=fsp_tol, krylov_tol=krylov_tol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return solver, res, stencil_cuda.LAUNCHES - before, wall


def _check_solve(tag, solver, res, launches, wsum_lo, wsum_hi):
    import torch

    s = res.stats
    if solver.dtype != torch.float64:
        raise AssertionError(f"{tag}: solve ran in {solver.dtype}")
    if s.iflag != 0:
        raise AssertionError(f"{tag}: iflag {s.iflag}")
    if not np.all(np.isfinite(res.probabilities)):
        raise AssertionError(f"{tag}: non-finite probabilities")
    if not wsum_lo <= res.wsum <= wsum_hi:
        raise AssertionError(f"{tag}: wsum {res.wsum} outside "
                             f"[{wsum_lo}, {wsum_hi}]")
    if launches < s.nmult:
        raise AssertionError(f"{tag}: {launches} kernel launches < nmult "
                             f"{s.nmult}")


def _print_solve(tag, solver, res, launches, wall):
    s = res.stats
    print(f"[{tag}] nstep {s.nstep} nmult {s.nmult} nreject {s.nreject} "
          f"nexph {s.nexph} expansions {s.n_expansions} drops {s.n_drops} "
          f"fsp {s.final_fsp_size} box {res.box.shape} vol {res.box.volume} "
          f"m_eff {solver.m_eff(res.box)} wsum {res.wsum:.10f} "
          f"launches {launches} wall {wall:.2f} s")


def phase_toggle():
    from krylovfspssa_tpu_torch.models.library import toggle_file_model

    args = (toggle_file_model(), 1000.0, [[0, 0]], 1e-4, 1e-10)
    solver, res, launches, wall = _solve(*args)
    _print_solve("toggle", solver, res, launches, wall)
    _check_solve("toggle", solver, res, launches, 1 - 1e-4, 1 + 1e-4)
    # a t=5 window of the same scenario: a trace of all of t=1000 holds
    # ~10^6 events and takes minutes to reduce
    _profile("toggle t=5", (toggle_file_model(), 5.0, [[0, 0]], 1e-4, 1e-10))


def _device_us(e) -> float:
    """Device time of a kernel or copy event; 0 for host-side ops (an aten
    op also carries the time of the kernels it launched, which would count
    them twice)."""
    from torch.autograd import DeviceType

    if e.device_type != DeviceType.CUDA:
        return 0.0
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _profile(tag, args):
    """Device-busy and host-synchronisation shares of one solve.  The
    solve runs once plainly (its wall is the denominator) and once under
    torch.profiler (kernel times and the count of host syncs; the
    profiler slows the host, not the kernels)."""
    from torch.profiler import ProfilerActivity, profile

    res, wall = _solve(*args)[1::2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = _solve(*args)[3]
    events = prof.key_averages()
    dev_us = sum(_device_us(e) for e in events)
    syncs = [e for e in events if e.key == "cudaStreamSynchronize"]
    n_sync = sum(e.count for e in syncs)
    blocked_us = sum(e.cpu_time_total for e in events
                     if e.key in ("cudaStreamSynchronize", "cudaMemcpyAsync"))
    if dev_us == 0.0:
        print(f"[profile] {tag}: no device time in the trace; busy and "
              f"sync shares not measured (wall {wall:.3f} s)")
        return
    print(f"[profile] {tag}: wall {wall:.3f} s (nmult {res.stats.nmult}), "
          f"kernel time {dev_us / 1e6:.3f} s = device busy "
          f"{100 * dev_us / 1e6 / wall:.1f}% of that wall; {n_sync} host "
          f"syncs ({1e6 * wall / max(n_sync, 1):.0f} us of wall per sync); "
          f"under the profiler (wall {wall_prof:.3f} s) the host was "
          f"blocked in syncs/D2H copies {blocked_us / 1e6:.3f} s")
    for e in sorted(events, key=lambda e: -_device_us(e))[:6]:
        print(f"[profile]   {e.key[:60]:60s} {_device_us(e) / 1e3:9.1f} ms "
              f"x{e.count}")


def phase_goutsias():
    import torch

    from krylovfspssa_tpu_torch.models.library import goutsias_model

    torch.cuda.reset_peak_memory_stats()
    solver, res, launches, wall = _solve(
        goutsias_model(), 10.0, [[2, 6, 0, 2, 0, 0]], 1e-6, 1e-8
    )
    _print_solve("goutsias", solver, res, launches, wall)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[goutsias] peak device memory {peak:.2f} GiB; JAX package on a "
          f"CPU (stepwise, float64): {JAX_GOUTSIAS_T10}")
    _check_solve("goutsias", solver, res, launches, 1 - 1e-6, 1 + 1e-6)
    if res.box.volume < 1 << 22:
        raise AssertionError(f"goutsias box volume {res.box.volume} < 2^22")
    del solver, res
    _profile("goutsias t=10", (goutsias_model(), 10.0, [[2, 6, 0, 2, 0, 0]],
                               1e-6, 1e-8))
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from krylovfspssa_tpu_torch.ops import stencil_cuda

    torch.cuda.set_device(0)
    smi = phase_env()
    flagship = phase_kernels()
    phase_small_solve()

    # the main path: every launch from here on is a solve's matvec
    stencil_cuda.LAUNCHES = 0
    phase_toggle()
    phase_goutsias()
    launches = stencil_cuda.LAUNCHES

    print(json.dumps({"kernels": [{
        "name": "box_stencil",
        "route": "cuda",
        "source": "krylovfspssa_tpu_torch/csrc/box_stencil.cu",
        "replaces": "krylovfspssa_tpu/ops/pallas_stencil.py:1149",
        "launches": launches,
        "max_abs_err": flagship["max_abs_err"],
        "ms": flagship["ms"],
        "plain_ms": flagship["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
