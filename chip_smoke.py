#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``krylovfspssa_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sharded-only    # several cards: [sharded] alone

Builds the hand-written stencil kernels from ``krylovfspssa_tpu_torch/csrc``
with nvcc, drives the port's three solve paths through
``solve_cme_box``/``BoxCmeSolver`` on ``cuda``, then holds each kernel
against its plain PyTorch version on the card at the shapes of those paths:

  1. environment: card name and power limit, torch/CUDA versions, kernel
     build time and nvcc's register report; a small toggle solve on the
     card against the same solve on the CPU;
  2. separable models (``box_stencil``): the reference driver
     TestSolverFromFile — toggle, t=1000, fsp_tol 1e-4, krylov_tol 1e-10
     (float64) — and the Goutsias example (reference
     examples/transcr6d.f90) at its reference tolerances to t=10, which
     ends in a 2^22-cell box;
  3. custom propensities (``direct_stencil``): the CUSTOMPROP driver
     (reference examples/toggle.f90: ``toggle_programmatic``, t=100,
     fsp_tol 1e-4, krylov_tol 1e-10), and ``ge5d`` at real size through the
     library's callable and through ``models/ge5d_model.input`` (separable,
     ``box_stencil``), which must agree; the CUSTOMPROP and library ge5d
     solves keep the last input they gave ``direct_stencil`` (one device
     copy of x per matvec) for phase 6;
  4. ``[sharded]``: the Goutsias solve of phase 2 row-sharded through
     ``solve_cme_box(..., mesh=...)`` in spawned ranks (one card per rank
     with NCCL when two or more cards are visible, up to 4; otherwise 2
     gloo ranks on ``cuda:0``), held against the one-rank solve of phase 2,
     with the cost of one all_reduce and one halo swap, and once more with
     rank 0 under torch.profiler (collective counts, the largest device
     items);
  5. ``[kernels]``: ``box_stencil`` vs its plain version at three box
     geometries (the 2^22-cell Goutsias box, a 512x512 toggle box, a
     128-cell box smaller than one thread block) in float64 and float32,
     and on the final mask and w of the toggle and Goutsias solves of
     phase 2 (the kernel's inputs on that path: about 24% and 1.4% of
     their boxes active);
  6. ``[direct]``: ``direct_stencil`` vs its plain version (bit for bit in
     float64) on the 2^22-cell Goutsias box (also against ``box_stencil``:
     the model is separable), a 512x512 ``toggle_programmatic`` box and
     the box the ge5d solve reached, in float64 and float32, and on the
     last matvec input of the CUSTOMPROP toggle and ge5d solves of phase 3;
  7. ``[halo]``: ``halo_stencil`` vs its plain version on every row shard
     of the 2^22-cell Goutsias box and of the box the Goutsias solve of
     phase 2 ended in (the one [sharded] runs), each cut into 1, 2 and 4
     shards on one card (halos cut from the global vector), float64 and
     float32, and the concatenated shards vs ``box_stencil`` on the whole
     vector (bit for bit), with the times per shard beside
     ``box_stencil``'s.

Every line of 5-7 gives the kernel's time, its plain version's, its bound
(the bytes the function needs on this run's data over 3.35 TB/s: the
mask and y everywhere, x and D or the fields only at active cells; or
operations over the peak rate), its launches on the solve paths, and the time of one PyTorch
call that computes the same y (a CSR SpMV of the masked generator, built
from the kernel's operands; the port never calls it).  Inputs of the
kernels meet their contract ``supp(x) ⊆ mask``.

Each solve path (2, 3 and 4) runs with the kernels' launch counts set to 0
just before it and read just after (in each rank, for 4).  Each phase
prints its own lines with its wall time.  Any failure raises and exits
non-zero.  The last lines are a JSON record of the kernels, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: counts the JAX package's stepwise box solve reached on this scenario
#: (Goutsias, t=10, fsp_tol 1e-6, krylov_tol 1e-8, float64, on a CPU);
#: printed beside the port's for comparison, not asserted
JAX_GOUTSIAS_T10 = dict(box_volume=1 << 22, box_shape=(32, 4, 4, 64, 32, 4),
                        fsp_size=57023, nstep=8, nmult=175, nreject=6,
                        wsum=0.99999991)

F64_RTOL = 1e-12
F32_RTOL = 1e-5

#: H100 SXM device memory rate, and its peak arithmetic rates outside the
#: tensor cores (NVIDIA's data sheet): the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

#: the ge5d scenario of tests/test_models_e2e.py (x0 = 0, fsp_tol 1e-4,
#: krylov_tol 1e-8, box_min_log2 2) cut from t=2 to t=1: at t=2 the box
#: outgrows max_box_volume (2^23) in both packages; by t=1 it is 2^23 cells
GE5D_T = 1.0


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


#: GPU clock cycles of the sleep that holds the stream while the host
#: queues a timed run (about 5 ms at the H100's clocks)
SLEEP_CYCLES = 10_000_000


def _time_ms(fn, *args, warmup=3, launches=20, rounds=5) -> float:
    """Device milliseconds per call: the stream sleeps while the host
    queues ``launches`` calls between two CUDA events, so the calls run
    back to back on the card whatever their host enqueue costs (ctypes,
    checks, allocation); the median of ``rounds`` such runs, over the
    count.  A function that synchronises with the host (the plain versions
    read operands back) is timed at its host rate.  L2 is warm: each call
    finds what the one before it left; at 2^18 cells every operand fits in
    the 50 MB L2, at 2^22 cells (about 100 MB of x, D and y in float64) it
    does not."""
    import torch

    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    runs = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(launches):
            fn(*args)
        b.record()
        runs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) / launches for a, b in runs)


def _bound(nbytes, flops, dt):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``flops`` of type ``dt``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dt)[6:]]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _sep_bound(pack, mask, halos):
    """box_stencil's / halo_stencil's bound from what the function needs
    on this run's data: the mask and y over the rows, x and D at the active
    cells (x is 0 elsewhere, by the contract), the halos; -D*x and a
    multiply-add per reaction for every active cell."""
    active = int(mask.sum())
    item = pack.diag.element_size()
    nbytes = (pack.rows * (1 + item) + 2 * active * item
              + _nbytes(*halos))
    return _bound(nbytes, active * (1 + 2 * pack.n_reactions), pack.dtype)


def _csr(rows, cols, vals, shape):
    """A CSR matrix (int32 indices) from coordinate lists."""
    import torch

    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    order = torch.argsort(rows * shape[1] + cols)
    rows, cols, vals = rows[order], cols[order], vals[order]
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=shape[0]), 0)
    return torch.sparse_csr_tensor(crow.int(), cols.int(), vals, shape,
                                   check_invariants=False)


def _sep_csr(pack, mask):
    """The masked generator of a separable pack's rows as a CSR matrix
    over the padded sources ``[left | x | right]`` (H cells each side),
    from every factor of each reaction per cell (not the kernel's tile
    table): the library yardstick, y = A @ xpad."""
    import torch

    from krylovfspssa_tpu_torch.ops import stencil_cuda as sc

    H, n = pack.halo, pack.rows
    i = torch.nonzero(mask).squeeze(1)
    rows, cols, vals = [i], [H + i], [-pack.diag[i]]
    for k, off in enumerate(pack.meta[:pack.n_reactions].tolist()):
        u = sc._propensity(pack, k, pack.z0 + i)
        j = i - off
        inside = (j >= 0) & (j < n)
        keep = (u != 0) & (~inside | mask[j.clamp(0, n - 1)])
        rows.append(i[keep])
        cols.append(H + j[keep])
        vals.append(u[keep])
    return _csr(rows, cols, vals, (n, n + 2 * H))


def _direct_csr(pack, mask):
    """direct_stencil's masked generator as a CSR matrix (the library
    yardstick, y = A @ x), from the kernel's diagonal and rates."""
    import torch

    vol = pack.volume
    i = torch.nonzero(mask).squeeze(1)
    rows, cols, vals = [i], [i], [-pack.diag[i]]
    for k, off in enumerate(pack.meta.tolist()):
        u = pack.rates[k][i]
        j = i - off  # inside the box wherever u != 0
        keep = (u != 0) & mask[j.clamp(0, vol - 1)]
        rows.append(i[keep])
        cols.append(j[keep])
        vals.append(u[keep])
    return _csr(rows, cols, vals, (vol, vol))


def _library(matrix, v, ref, rtol, scale=None):
    """Milliseconds of ``matrix @ v`` (the yardstick), after checking that
    it gives the kernel's y to ``rtol`` x ``scale`` (default max|y|)."""
    import torch

    y = matrix @ v
    if scale is None:
        scale = float(torch.max(torch.abs(ref)))
    err = float(torch.max(torch.abs(y - ref)))
    if not err <= rtol * scale:
        raise AssertionError(f"CSR yardstick disagrees with the kernel: "
                             f"{err:.3e} > {rtol:g} x {scale:.3e}")
    return _time_ms(torch.matmul, matrix, v)


def _row(err, ms, plain_ms, bound, library_ms, launches):
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=library_ms, launches=launches)


def _us(row) -> str:
    return (f"kernel {row['ms'] * 1e3:.2f} us, plain "
            f"{row['plain_ms'] * 1e3:.1f} us, bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}; "
            f"{100 * row['bound_ms'] / row['ms']:.0f}% of it), CSR library "
            f"{row['library_ms'] * 1e3:.1f} us, launches on the solve paths "
            f"{row['launches']}")


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
    print(f"[env] kernels (sep_stencil: separable mode for box_stencil and "
          f"halo_stencil, direct mode for direct_stencil) built in "
          f"{info.seconds:.2f} s -> {info.path}")
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[env]   {line.strip()}")
    print(f"[env] wall {time.perf_counter() - t0:.2f} s")
    return smi


def _final_inputs(res):
    """The mask and the (clipped) w a solve ended with, on the card: the
    kernel's inputs on that solve path, not a random mask."""
    import torch

    idx = res.box.flat_index(res.states).to("cuda")
    mask = torch.zeros(res.box.volume, dtype=torch.bool, device="cuda")
    mask[idx] = True
    x = torch.zeros(res.box.volume, dtype=torch.float64, device="cuda")
    x[idx] = torch.as_tensor(res.probabilities, device="cuda")
    return mask, x


class _LastInput:
    """While active, wraps ``stencil_cuda.<name>`` so that a solve keeps
    the last (mask, x) it gave the kernel: the kernel's input on that solve
    path.  Each call copies x on the card into a buffer kept here (one
    device copy, no host sync); the mask is kept by reference, since the
    solver builds a new mask wherever one changes (the version counter
    shows it was not written since)."""

    def __init__(self, name):
        self.name = name
        self.mask = self.x = None

    def __enter__(self):
        import torch

        from krylovfspssa_tpu_torch.ops import stencil_cuda

        kernel = getattr(stencil_cuda, self.name)

        def keep_last(pack, mask, x):
            if self.x is None or self.x.shape != x.shape:
                self.x = torch.empty_like(x)
            self.x.copy_(x)
            self.mask, self.version = mask, mask._version
            return kernel(pack, mask, x)

        self._kernel = kernel
        setattr(stencil_cuda, self.name, keep_last)
        return self

    def __exit__(self, *exc):
        from krylovfspssa_tpu_torch.ops import stencil_cuda

        setattr(stencil_cuda, self.name, self._kernel)
        return False

    def inputs(self):
        """The last (mask, x), moved to the host; frees the buffer."""
        if self.mask is None or self.mask._version != self.version:
            raise AssertionError(f"no intact last input of {self.name}")
        out = self.mask.cpu(), self.x.cpu()
        self.mask = self.x = None
        return out


def phase_kernels(launches, finals):
    """box_stencil vs its plain version on the card, on random masks and on
    the final mask and w of the solves in ``finals`` ({name: (model,
    result)}); returns the flagship (2^22-cell Goutsias, float64) row."""
    import torch

    from krylovfspssa_tpu_torch.models.library import (
        goutsias_model,
        repressilator_model,
        toggle_file_model,
    )
    from krylovfspssa_tpu_torch.ops import stencil_cuda as sc

    t0 = time.perf_counter()
    cases = [
        ("goutsias-2^22", goutsias_model(), [[2, 6, 0, 2, 0, 0]],
         [64, 64, 16, 4, 4, 4]),
        ("toggle-512x512", toggle_file_model(), [[0, 0]], [512, 512]),
        ("repressilator-128", repressilator_model(), [[0, 0, 0]], [4, 4, 8]),
    ]
    flagship = None
    runs = [(name, model, _grown(model, x0, targets), dt, rtol,
             _face_inputs)
            for name, model, x0, targets in cases
            for dt, rtol in ((torch.float64, F64_RTOL),
                             (torch.float32, F32_RTOL))]
    runs += [(f"{name}-solve-final", model, res.box, torch.float64, F64_RTOL,
              lambda box, dt, res=res: _final_inputs(res))
             for name, (model, res) in finals.items()]
    for name, model, box, dt, rtol, inputs in runs:
        mask, x = inputs(box, dt)
        pack = sc.pack_stencil(model, box, dt, "cuda")
        y_k = sc.box_stencil(pack, mask, x)
        y_p = sc._box_stencil_plain(pack, mask, x)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(y_k - y_p)))
        # errors are relative to the terms of the sum: near a steady state
        # (a solve's final w) y = A w nearly cancels, and max|y| is no scale
        scale = max(float(torch.max(torch.abs(y_p))),
                    float(torch.max(torch.abs(pack.diag * x))))
        zeros = x.new_zeros(pack.halo)
        row = _row(
            err, _time_ms(sc.box_stencil, pack, mask, x),
            _time_ms(sc._box_stencil_plain, pack, mask, x),
            _sep_bound(pack, mask, ()),
            _library(_sep_csr(pack, mask), torch.cat([zeros, x, zeros]),
                     y_k, rtol, scale),
            launches)
        print(f"[kernels] {name} {str(dt)[6:]} vol={box.volume} active "
              f"{float(mask.float().mean()):.4f} tile "
              f"{1 << pack.log2_tile}; max_abs_err={err:.3e} (limit "
              f"{rtol:g} x {scale:.3e}); {_us(row)}")
        if not err <= rtol * scale:
            raise AssertionError(
                f"{name} {dt}: kernel disagrees with the plain version "
                f"({err:.3e} > {rtol:g} x {scale:.3e})"
            )
        if flagship is None:
            flagship = row
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


def _launches() -> dict:
    from krylovfspssa_tpu_torch.ops import stencil_cuda

    return {"box_stencil": stencil_cuda.LAUNCHES,
            "direct_stencil": stencil_cuda.DIRECT_LAUNCHES,
            "halo_stencil": stencil_cuda.HALO_LAUNCHES}


def _reset_launches():
    from krylovfspssa_tpu_torch.ops import stencil_cuda

    stencil_cuda.LAUNCHES = 0
    stencil_cuda.DIRECT_LAUNCHES = 0
    stencil_cuda.HALO_LAUNCHES = 0


def _solve(model, t, x0, fsp_tol, krylov_tol, config=None):
    """One solve on the card; returns (solver, result, launches of each
    kernel during the solve, wall seconds)."""
    import torch

    from krylovfspssa_tpu_torch import BoxCmeSolver

    solver = BoxCmeSolver(model, config, device="cuda")
    before = _launches()
    t0 = time.perf_counter()
    res = solver.solve(t, x0, fsp_tol=fsp_tol, krylov_tol=krylov_tol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in _launches().items()}
    return solver, res, launches, wall


def _check_solve(tag, solver, res, launches, wsum_lo, wsum_hi,
                 kernel="box_stencil"):
    """The correctness gate of one solve; every matvec went through
    ``kernel`` and none through the other one."""
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
    if launches[kernel] < s.nmult:
        raise AssertionError(f"{tag}: {launches[kernel]} {kernel} launches "
                             f"< nmult {s.nmult}")
    other = sum(n for k, n in launches.items() if k != kernel)
    if other:
        raise AssertionError(f"{tag}: {launches} — expected only {kernel}")


def _print_solve(tag, solver, res, launches, wall):
    s = res.stats
    print(f"[{tag}] nstep {s.nstep} nmult {s.nmult} nreject {s.nreject} "
          f"nexph {s.nexph} expansions {s.n_expansions} drops {s.n_drops} "
          f"fsp {s.final_fsp_size} box {res.box.shape} vol {res.box.volume} "
          f"m_eff {solver.m_eff(res.box)} wsum {res.wsum:.10f} "
          f"launches {launches} wall {wall:.2f} s")


def _l1(a, b) -> float:
    """L1 distance of two solve results over the union of their states."""
    sa = a.states.astype(np.int64)
    sb = b.states.astype(np.int64)
    base = int(max(sa.max(), sb.max())) + 1
    radix = base ** np.arange(sa.shape[1], dtype=np.int64)
    ka, kb = sa @ radix, sb @ radix
    keys = np.union1d(ka, kb)
    pa = np.zeros(keys.size)
    pb = np.zeros(keys.size)
    pa[np.searchsorted(keys, ka)] = a.probabilities
    pb[np.searchsorted(keys, kb)] = b.probabilities
    return float(np.abs(pa - pb).sum())


def phase_toggle():
    """Returns the solve's result."""
    from krylovfspssa_tpu_torch.models.library import toggle_file_model

    args = (toggle_file_model(), 1000.0, [[0, 0]], 1e-4, 1e-10)
    solver, res, launches, wall = _solve(*args)
    _print_solve("toggle", solver, res, launches, wall)
    _check_solve("toggle", solver, res, launches, 1 - 1e-4, 1 + 1e-4)
    # a t=5 window of the same scenario: a trace of all of t=1000 holds
    # ~10^6 events and takes minutes to reduce
    _profile("toggle t=5", (toggle_file_model(), 5.0, [[0, 0]], 1e-4, 1e-10))
    return res


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


GOUTSIAS = (10.0, [[2, 6, 0, 2, 0, 0]], 1e-6, 1e-8)


def phase_goutsias():
    """Returns the solve's result (the one-rank reference of [sharded])."""
    import torch

    from krylovfspssa_tpu_torch.models.library import goutsias_model

    torch.cuda.reset_peak_memory_stats()
    solver, res, launches, wall = _solve(goutsias_model(), *GOUTSIAS)
    _print_solve("goutsias", solver, res, launches, wall)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[goutsias] peak device memory {peak:.2f} GiB; JAX package on a "
          f"CPU (stepwise, float64): {JAX_GOUTSIAS_T10}")
    _check_solve("goutsias", solver, res, launches, 1 - 1e-6, 1 + 1e-6)
    if res.box.volume < 1 << 22:
        raise AssertionError(f"goutsias box volume {res.box.volume} < 2^22")
    del solver
    _profile("goutsias t=10", (goutsias_model(), *GOUTSIAS))
    return res


def _face_inputs(box, dt, seed=0):
    """A random mask (60% of cells) with every face of the box switched on
    — where the kernels' validity tests decide — and random x inside it
    (the separable kernel's contract supp(x) ⊆ mask)."""
    import torch

    rng = np.random.default_rng(seed)
    m = (rng.random(box.volume) < 0.6).reshape(box.shape)
    for ax in range(len(box.shape)):
        sl = [slice(None)] * len(box.shape)
        for edge in (0, -1):
            sl[ax] = edge
            m[tuple(sl)] = True
    mask = torch.as_tensor(m.reshape(-1), device="cuda")
    x = torch.as_tensor(rng.random(box.volume), dtype=dt, device="cuda")
    return mask, torch.where(mask, x, 0)


def _direct_case(name, model, box, launches, solve_input=None):
    """direct_stencil vs its plain version (bit for bit in float64) and vs
    make_stencil_matvec, or box_stencil for a separable model, on one
    geometry: random inputs with every face active in f64 and f32, or
    ``solve_input``, the (mask, x) a solve last gave the kernel, in f64.
    Returns the first row."""
    import torch

    from krylovfspssa_tpu_torch.ops import stencil_cuda
    from krylovfspssa_tpu_torch.ops.stencil import (
        _factored_reaction_tables,
        make_stencil_matvec,
    )

    separable = _factored_reaction_tables(model, box) is not None
    if solve_input is None:
        runs = [(dt, rtol, _face_inputs(box, dt))
                for dt, rtol in ((torch.float64, F64_RTOL),
                                 (torch.float32, F32_RTOL))]
    else:
        runs = [(torch.float64, F64_RTOL, [t.cuda() for t in solve_input])]
    row = None
    for dt, rtol, (mask, x) in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pack = stencil_cuda.pack_direct_stencil(model, box, dt, "cuda")
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        build_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        kern = lambda m, v: stencil_cuda.direct_stencil(pack, m, v)  # noqa
        plain = lambda m, v: stencil_cuda._direct_stencil_plain(pack, m, v)  # noqa
        if separable:  # the destination-form kernel: same y
            bpack = stencil_cuda.pack_stencil(model, box, dt, "cuda")
            ref_name = "box_stencil"
            ref = lambda m, v: stencil_cuda.box_stencil(bpack, m, v)  # noqa
        else:
            ref_name = "make_stencil_matvec"
            ref = make_stencil_matvec(model, box, dt, "cuda")
        y_k, y_p, y_r = kern(mask, x), plain(mask, x), ref(mask, x)
        torch.cuda.synchronize()
        # near a steady state (a solve's last input) y = A x nearly
        # cancels, and max|y| is no scale: the largest term |D x| is
        scale = max(float(torch.max(torch.abs(y_p))),
                    float(torch.max(torch.abs(pack.diag * x))))
        err = float(torch.max(torch.abs(y_k - y_p)))
        err_r = float(torch.max(torch.abs(y_k - y_r)))
        ms_r = _time_ms(ref, mask, x)
        R = model.n_reactions
        # what the function needs on this data: the mask and y over the
        # box, x at the active cells; the R fields there too for a Python
        # callable (a kernel cannot evaluate it), not for expressions (a
        # kernel can).  Per active cell the R-term diagonal and a validity
        # test, product and add per reaction
        active = int(mask.sum())
        ops = active * (3 * R + 1)
        nbytes = _nbytes(x, mask) + active * x.element_size()
        bare = _bound(nbytes, ops, dt)
        with_fields = _bound(nbytes + R * active * x.element_size(), ops,
                             dt)
        callable_ = model.custom_propensity is not None
        this = _row(err, _time_ms(kern, mask, x), _time_ms(plain, mask, x),
                    with_fields if callable_ else bare,
                    _library(_direct_csr(pack, mask), x, y_k, rtol, scale),
                    launches)
        row = row or this
        print(f"[direct] {name} {str(dt)[6:]} vol={box.volume} R={R} "
              f"{'callable' if callable_ else 'expressions'} active "
              f"{active / box.volume:.4f} max_abs_err={err:.3e} vs plain, "
              f"{err_r:.3e} vs {ref_name} (limit {rtol:g} x {scale:.3e}); "
              f"{_us(this)}; bound without the fields {bare[0] * 1e3:.2f} "
              f"us, with them {with_fields[0] * 1e3:.2f} us (kernel at "
              f"{100 * with_fields[0] / this['ms']:.0f}% of it); {ref_name} "
              f"{ms_r * 1e3:.1f} us; fields built in {build_ms:.1f} ms, "
              f"peak {build_mib:.1f} MiB above the inputs")
        exact = err == 0.0 or dt != torch.float64
        if not (exact and err <= rtol * scale and err_r <= rtol * scale):
            raise AssertionError(
                f"{name} {dt}: direct_stencil disagrees ({err:.3e} vs "
                f"plain, bit for bit in float64; {err_r:.3e} vs "
                f"{ref_name}; limit {rtol:g} x {scale:.3e})"
            )
        del pack
    return row


def phase_direct_kernels(launches, ge5d, ge5d_box, finals):
    """direct_stencil on the card at the 2^22-cell Goutsias box (forced
    through the direct form), a 512x512 toggle_programmatic box and the box
    the ge5d solve reached, and on the last inputs of the solves in
    ``finals`` ({name: (model, box, (mask, x))}); returns the Goutsias f64
    row."""
    from krylovfspssa_tpu_torch.models.library import (
        goutsias_model,
        toggle_programmatic_model,
    )

    t0 = time.perf_counter()
    flagship = _direct_case(
        "goutsias-2^22", goutsias_model(),
        _grown(goutsias_model(), [[2, 6, 0, 2, 0, 0]], [64, 64, 16, 4, 4, 4]),
        launches)
    _direct_case(
        "toggle_programmatic-512x512", toggle_programmatic_model(),
        _grown(toggle_programmatic_model(), [[0, 0]], [512, 512]), launches)
    _direct_case("ge5d-solve-box", ge5d, ge5d_box, launches)
    for name, (model, box, inputs) in finals.items():
        _direct_case(f"{name}-solve-final", model, box, launches, inputs)
    print(f"[direct] wall {time.perf_counter() - t0:.2f} s")
    return flagship


def _solve_input(tag, last, res):
    """The solve's final box and the last (mask, x) ``last`` (a
    _LastInput) caught on it, on the host."""
    mask, x = last.inputs()
    if mask.numel() != res.box.volume:
        raise AssertionError(f"{tag}: last input of {mask.numel()} cells, "
                             f"final box {res.box.volume}")
    return res.box, (mask, x)


def phase_customprop():
    """The CUSTOMPROP driver (reference examples/toggle.f90); returns the
    model, the final box and the last input the solve gave direct_stencil
    (each matvec's x is copied once on the card to keep it)."""
    from krylovfspssa_tpu_torch.models.library import (
        toggle_programmatic_model,
    )

    args = (toggle_programmatic_model(), 100.0, [[0, 0]], 1e-4, 1e-10)
    with _LastInput("direct_stencil") as last:
        solver, res, launches, wall = _solve(*args)
    _print_solve("customprop", solver, res, launches, wall)
    _check_solve("customprop", solver, res, launches, 1 - 1e-4, 1 + 1e-4,
                 kernel="direct_stencil")
    # a t=5 window, as for the toggle reference driver
    _profile("toggle_programmatic t=5",
             (toggle_programmatic_model(), 5.0, [[0, 0]], 1e-4, 1e-10))
    return (args[0], *_solve_input("customprop", last, res))


def phase_ge5d():
    """ge5d at real size through the library's custom callable
    (direct_stencil) and through models/ge5d_model.input (separable,
    box_stencil, with the library's parameters); returns the model, the
    box the library solve reached and its last input to direct_stencil."""
    import torch

    from krylovfspssa_tpu_torch import SolverConfig, load_model
    from krylovfspssa_tpu_torch.models.library import ge5d_model

    lib = ge5d_model()
    inp = load_model(Path(__file__).resolve().parent / "models"
                     / "ge5d_model.input")
    inp.reset_parameters(lib.parameters)
    fsp_tol = 1e-4
    results = []
    last = _LastInput("direct_stencil")
    for tag, model, kernel in (("ge5d-library", lib, "direct_stencil"),
                               ("ge5d-input", inp, "box_stencil")):
        torch.cuda.reset_peak_memory_stats()
        with last if model is lib else contextlib.nullcontext():
            solver, res, launches, wall = _solve(
                model, GE5D_T, [[0, 0, 0, 0, 0]], fsp_tol, 1e-8,
                SolverConfig(box_min_log2=2))
        _print_solve(tag, solver, res, launches, wall)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        held = ""
        if model is lib:
            held = (f" (with the {res.box.volume * 9 / 2 ** 20:.0f} MiB "
                    "that hold the last input)")
            captured = _solve_input("ge5d", last, res)
        print(f"[{tag}] t={GE5D_T} peak device memory {peak:.2f} GiB{held}")
        _check_solve(tag, solver, res, launches, 1 - fsp_tol, 1 + fsp_tol,
                     kernel=kernel)
        if res.box.volume < 1 << 20:
            raise AssertionError(f"{tag}: box volume {res.box.volume} < 2^20")
        results.append(res)
        del solver
    l1 = _l1(*results)
    print(f"[ge5d] library vs .input: L1 {l1:.3e} (limit {2 * fsp_tol:g})")
    if not l1 <= 2 * fsp_tol:
        raise AssertionError(f"ge5d library and .input solves differ: "
                             f"L1 {l1:.3e}")
    _profile("ge5d-library t=%g" % GE5D_T,
             (lib, GE5D_T, [[0, 0, 0, 0, 0]], fsp_tol, 1e-8,
              SolverConfig(box_min_log2=2)))
    return lib, *captured


def phase_halo(solve_box, launches):
    """halo_stencil on the card at two geometries: the 2^22-cell Goutsias
    box and ``solve_box``, the box the Goutsias solve of phase 2 ended in
    (the box [sharded] runs), each cut into P = 1, 2 and 4 row shards on
    one card, each shard's halos cut from the global masked x (every face
    of the box active).  Kernel vs plain version per shard; the
    concatenated shards vs box_stencil on the whole vector, bit for bit;
    P=1 times the kernel on the whole box (zero halos) beside box_stencil.
    Returns the 2^22 P=2 float64 row (worst shard error, median shard
    times)."""
    import torch

    from krylovfspssa_tpu_torch.models.library import goutsias_model

    t0 = time.perf_counter()
    model = goutsias_model()
    grown = _grown(model, [[2, 6, 0, 2, 0, 0]], [64, 64, 16, 4, 4, 4])
    flagship = None
    for name, box in (("goutsias-2^22", grown),
                      ("goutsias-solve-box", solve_box)):
        for dt, rtol in ((torch.float64, F64_RTOL),
                         (torch.float32, F32_RTOL)):
            rows = _halo_case(name, model, box, dt, rtol, launches)
            if flagship is None:
                flagship = rows[2]
    print(f"[halo] wall {time.perf_counter() - t0:.2f} s")
    return flagship


def _halo_case(name, model, box, dt, rtol, launches):
    """halo_stencil on one geometry and dtype for P = 1, 2, 4; returns
    {P: row} (worst shard error, median shard times)."""
    import torch

    from krylovfspssa_tpu_torch.ops import stencil_cuda as sc
    from krylovfspssa_tpu_torch.ops.halo import halo_from_global, halo_width

    H = halo_width(box)
    mask, x = _face_inputs(box, dt)
    bpack = sc.pack_stencil(model, box, dt, "cuda")
    whole = sc.box_stencil(bpack, mask, x)
    ms_box = _time_ms(sc.box_stencil, bpack, mask, x)
    scale = float(torch.max(torch.abs(whole)))
    out = {}
    for n_ranks in (1, 2, 4):
        L = box.volume // n_ranks
        shards, rows = [], []
        for r in range(n_ranks):
            z0 = r * L
            pack = sc.pack_halo_stencil(model, box, dt, "cuda", z0, L)
            halos = halo_from_global(x, z0, L, H)
            args = (pack, mask[z0:z0 + L], x[z0:z0 + L], *halos)
            y_k = sc.halo_stencil(*args)
            y_p = sc._halo_stencil_plain(*args)
            torch.cuda.synchronize()
            rows.append(_row(
                float(torch.max(torch.abs(y_k - y_p))),
                _time_ms(sc.halo_stencil, *args),
                _time_ms(sc._halo_stencil_plain, *args),
                _sep_bound(pack, args[1], halos),
                _library(_sep_csr(pack, args[1]),
                         torch.cat([halos[0], args[2], halos[1]]), y_k, rtol),
                launches))
            shards.append(y_k)
        bitwise = torch.equal(torch.cat(shards), whole)
        row = dict(rows[0], **{key: statistics.median(r[key] for r in rows)
                               for key in ("ms", "plain_ms", "bound_ms",
                                           "library_ms")})
        row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        per_shard = {key: " ".join("%.2f" % (r[key] * 1e3) for r in rows)
                     for key in ("ms", "plain_ms", "library_ms")}
        print(f"[halo] {name} {tuple(box.shape)} {str(dt)[6:]} P={n_ranks} "
              f"L={L} H={H} tile {1 << bpack.log2_tile}: max_abs_err="
              f"{row['max_abs_err']:.3e} vs plain (limit {rtol:g} x "
              f"{scale:.3e}), concatenated shards equal box_stencil bit for "
              f"bit: {bitwise}; per shard kernel {per_shard['ms']} us, plain "
              f"{per_shard['plain_ms']} us, CSR library "
              f"{per_shard['library_ms']} us; median {_us(row)}; "
              f"box_stencil whole {ms_box * 1e3:.2f} us (median shard / "
              f"box_stencil {row['ms'] / ms_box:.3f})")
        if not (row["max_abs_err"] <= rtol * scale and bitwise):
            raise AssertionError(
                f"halo_stencil disagrees on {name} at P={n_ranks} {dt}: "
                f"{row['max_abs_err']:.3e} vs plain (limit {rtol:g} x "
                f"{scale:.3e}); shards equal box_stencil: {bitwise}")
        out[n_ranks] = row
    return out


def _sharded_rank(mesh, args):
    """One rank of [sharded]: the Goutsias solve on this rank's rows, with
    this process's launch counts set to 0 just before it.  A t=1 solve
    first takes the fresh process's start-up (CUDA context, cuBLAS,
    communicators), so that the wall compares with phase 3's warm one, and
    a barrier starts every rank's clock together."""
    import torch

    from krylovfspssa_tpu_torch import BoxCmeSolver
    from krylovfspssa_tpu_torch.models.library import goutsias_model

    BoxCmeSolver(goutsias_model(), mesh=mesh).solve(
        1.0, args[1], fsp_tol=args[2], krylov_tol=args[3])
    torch.cuda.synchronize(mesh.device)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    solver = BoxCmeSolver(goutsias_model(), mesh=mesh)
    mesh.barrier()
    _reset_launches()
    t0 = time.perf_counter()
    res = solver.solve(args[0], args[1], fsp_tol=args[2], krylov_tol=args[3])
    torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak_gib = torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30
    return dict(
        rank=mesh.rank, device=str(mesh.device), dtype=str(solver.dtype),
        launches=launches, wall=wall, peak_gib=peak_gib,
        profile=_rank_profile(mesh, args, res.box),
        records=[dataclasses.replace(r, wall_s=0.0)
                 for r in res.stats.records],
        result=res if mesh.rank == 0 else None,
        stats=(res.stats.iflag, res.stats.nstep, res.stats.nmult,
               res.stats.nreject),
    )


def _rank_profile(mesh, args, box):
    """Where a sharded solve's time goes.  The same solve once more on
    every rank, rank 0's under torch.profiler: the number of each
    collective and the device time (NCCL's ``nccl:*`` ranges repeat their
    kernels' time and are left out).  The profiler slows rank 0's host
    several times over, so the cost of one collective is timed without it:
    a float64 all_reduce read back to the host, as every reduction of the
    solve is, and a halo swap at ``box``, each back to back on every rank
    after a barrier.  Returns rank 0's summary, None elsewhere."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from krylovfspssa_tpu_torch import BoxCmeSolver
    from krylovfspssa_tpu_torch.models.library import goutsias_model
    from krylovfspssa_tpu_torch.ops.halo import halo_width

    def us_per_call(fn, n):
        fn()
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize(mesh.device)
        return (time.perf_counter() - t0) / n * 1e6

    one = torch.zeros(1, dtype=torch.float64, device=mesh.device)
    x = torch.zeros(mesh.rows(box.volume)[1], dtype=torch.float64,
                    device=mesh.device)
    all_reduce_us = us_per_call(lambda: float(mesh.sum(one)), 300)
    swap_us = us_per_call(lambda: mesh.exchange_halo(x, halo_width(box)), 50)

    solver = BoxCmeSolver(goutsias_model(), mesh=mesh)
    prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if mesh.rank == 0 else contextlib.nullcontext())
    mesh.barrier()
    with prof:
        solver.solve(args[0], args[1], fsp_tol=args[2], krylov_tol=args[3])
        torch.cuda.synchronize(mesh.device)
    if mesh.rank:
        return None
    events = [e for e in prof.key_averages()
              if not e.key.startswith("nccl:")]

    def calls(prefix):
        return sum(e.count for e in events if e.key.startswith(prefix))

    return dict(
        all_reduce_us=all_reduce_us, swap_us=swap_us,
        calls={k: calls(f"c10d::{p}") for k, p in (
            ("all_reduce", "allreduce"), ("send", "send"),
            ("recv", "recv"), ("all_gather", "_allgather"))},
        device_ms=sum(_device_us(e) for e in events) / 1e3,
        top=[(e.key[:60], _device_us(e) / 1e3, e.count)
             for e in sorted(events, key=lambda e: -_device_us(e))[:6]],
    )


def phase_sharded(one_rank):
    """The Goutsias solve of phase 3 row-sharded over spawned ranks;
    returns the ranks' summed launch counts."""
    import torch

    from krylovfspssa_tpu_torch.parallel.multihost import spawn

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    if cards >= 2:
        devices, backend = [f"cuda:{r}" for r in range(min(cards, 4))], "nccl"
    else:
        devices, backend = ["cuda:0", "cuda:0"], "gloo"
    print(f"[sharded] {len(devices)} ranks, {backend}, on {devices} "
          f"({cards} cards visible)")
    outs = spawn(_sharded_rank, devices, (GOUTSIAS,), backend=backend,
                 timeout_s=600)
    for o in outs:
        iflag, nstep, nmult, nreject = o["stats"]
        print(f"[sharded] rank {o['rank']} on {o['device']}: nstep {nstep} "
              f"nmult {nmult} nreject {nreject} launches {o['launches']} "
              f"wall {o['wall']:.2f} s peak device memory "
              f"{o['peak_gib']:.2f} GiB")
    p = outs[0]["profile"]
    print(f"[sharded] rank 0: one float64 all_reduce read back "
          f"{p['all_reduce_us']:.0f} us, one halo swap {p['swap_us']:.0f} us "
          f"(unprofiled, back to back); profiled solve: calls {p['calls']}, "
          f"device time {p['device_ms']:.1f} ms")
    for key, ms, count in p["top"]:
        print(f"[sharded]   {key:60s} {ms:9.1f} ms x{count}")
    res = outs[0]["result"]
    l1 = _l1(res, one_rank)
    print(f"[sharded] wsum {res.wsum:.10f} box {res.box.shape} fsp "
          f"{res.stats.final_fsp_size}; one-rank (phase 3): box "
          f"{one_rank.box.shape} nstep {one_rank.stats.nstep} nmult "
          f"{one_rank.stats.nmult}; L1 to it {l1:.3e} (limit "
          f"{2 * GOUTSIAS[2]:g}); wall {time.perf_counter() - t0:.2f} s "
          "with spawning")
    fsp_tol = GOUTSIAS[2]
    for o in outs:
        iflag, nstep, nmult, _ = o["stats"]
        if iflag != 0 or o["dtype"] != "torch.float64":
            raise AssertionError(f"rank {o['rank']}: iflag {iflag}, "
                                 f"{o['dtype']}")
        if o["launches"]["halo_stencil"] < nmult:
            raise AssertionError(f"rank {o['rank']}: {o['launches']} "
                                 f"halo_stencil launches < nmult {nmult}")
        if o["launches"]["box_stencil"] or o["launches"]["direct_stencil"]:
            raise AssertionError(f"rank {o['rank']} launched another "
                                 f"kernel: {o['launches']}")
        if o["records"] != outs[0]["records"]:
            raise AssertionError(f"rank {o['rank']}'s step records differ "
                                 "from rank 0's")
    if not (np.all(np.isfinite(res.probabilities))
            and 1 - fsp_tol <= res.wsum <= 1 + fsp_tol):
        raise AssertionError(f"sharded wsum {res.wsum}")
    if res.box.shape != one_rank.box.shape or not l1 <= 2 * fsp_tol:
        raise AssertionError(f"sharded solve differs from the one-rank "
                             f"solve: box {res.box.shape} vs "
                             f"{one_rank.box.shape}, L1 {l1:.3e}")
    total = {k: sum(o["launches"][k] for o in outs)
             for k in outs[0]["launches"]}
    print(f"[sharded path] launches (all ranks): {total}")
    if total["halo_stencil"] == 0:
        raise AssertionError("sharded path: halo_stencil was never launched")
    return total


def _path_launches(tag, run, kernels):
    """Run one solve path with the launch counts set to 0 just before it;
    the counts read just after must show every kernel of the path."""
    _reset_launches()
    out = run()
    counts = _launches()
    print(f"[{tag}] launches: {counts}")
    for k in kernels:
        if counts[k] == 0:
            raise AssertionError(f"{tag}: {k} was never launched")
    return counts, out


def sharded_only(smi) -> int:
    """``--sharded-only``: the row-sharded path and what it is held
    against, alone (for a machine with several cards): the one-rank
    Goutsias solve of phase 3, after a t=1 warm-up solve so that its wall
    compares with the ranks' warm ones, then [sharded]."""
    from krylovfspssa_tpu_torch.models.library import goutsias_model

    t_start = time.perf_counter()
    _solve(goutsias_model(), 1.0, *GOUTSIAS[1:])
    _reset_launches()
    one = phase_goutsias()
    phase_sharded(one)
    print(f"[total] wall {time.perf_counter() - t_start:.1f} s")
    print(smi)
    return 0


def main(argv=None) -> int:
    import argparse

    import torch

    from krylovfspssa_tpu_torch.models.library import (
        goutsias_model,
        toggle_file_model,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sharded-only", action="store_true",
                    help="run only the one-rank Goutsias solve and "
                    "[sharded] (one NCCL rank per visible card, up to 4)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    torch.cuda.set_device(0)
    smi = phase_env()
    if args.sharded_only:
        return sharded_only(smi)
    t_start = time.perf_counter()
    phase_small_solve()

    # path 1, separable models: every launch is a solve's box_stencil matvec
    def separable():
        return phase_toggle(), phase_goutsias()

    sep, (toggle_one, goutsias_one) = _path_launches(
        "separable path", separable, ["box_stencil"])
    if sep["direct_stencil"] or sep["halo_stencil"]:
        raise AssertionError(f"separable models launched another kernel: "
                             f"{sep}")

    # path 2, custom propensities: direct_stencil (and box_stencil for the
    # .input ge5d that the library's ge5d is held against)
    def custom():
        return phase_customprop(), phase_ge5d()

    cus, (customprop, (ge5d, ge5d_box, ge5d_input)) = _path_launches(
        "custom path", custom, ["direct_stencil", "box_stencil"])
    # path 3, the row-sharded solve: halo_stencil in every rank
    shl = phase_sharded(goutsias_one)

    launches = {k: sep[k] + cus[k] + shl[k] for k in sep}
    print(f"[paths] launches of the three solve paths: {launches}")
    box = phase_kernels(launches["box_stencil"], {
        "toggle": (toggle_file_model(), toggle_one),
        "goutsias": (goutsias_model(), goutsias_one)})
    direct = phase_direct_kernels(
        launches["direct_stencil"], ge5d, ge5d_box,
        {"customprop": customprop, "ge5d": (ge5d, ge5d_box, ge5d_input)})
    halo = phase_halo(goutsias_one.box, launches["halo_stencil"])

    print(f"[total] wall {time.perf_counter() - t_start:.1f} s")
    sep_source = "krylovfspssa_tpu_torch/csrc/sep_stencil.cuh"
    print(json.dumps({"kernels": [dict({
        "name": "box_stencil",
        "route": "cuda",
        "source": sep_source,
        "replaces": "krylovfspssa_tpu/ops/pallas_stencil.py:1149",
        "also_replaces": ["krylovfspssa_tpu/ops/pallas_stencil.py:809",
                          "krylovfspssa_tpu/ops/pallas_stencil.py:486",
                          "krylovfspssa_tpu/ops/pallas_stencil.py:228"],
    }, **box), dict({
        "name": "direct_stencil",
        "route": "cuda",
        "source": sep_source,
        "replaces": "krylovfspssa_tpu/ops/pallas_stencil.py:2153",
        "also_replaces": ["krylovfspssa_tpu/ops/pallas_stencil.py:66"],
    }, **direct), dict({
        "name": "halo_stencil",
        "route": "cuda",
        "source": sep_source,
        "replaces": "krylovfspssa_tpu/ops/pallas_stencil.py:1828",
        "also_replaces": ["krylovfspssa_tpu/ops/pallas_stencil.py:1496"],
    }, **halo)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
