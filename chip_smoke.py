#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``krylovfspssa_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sharded-only    # several cards: the sharded
                                            # paths alone
    python3 chip_smoke.py --table-flagship  # Goutsias t=300 alone

Builds the hand-written stencil, Padé and Arnoldi-column kernels from
``krylovfspssa_tpu_torch/csrc`` with nvcc (and the table backend's native hash with g++), drives the port's
three box solve paths through ``solve_cme_box``/``BoxCmeSolver`` and its
table path through ``CmeSolver`` on ``cuda`` -- in the default fused main
loop (krylov/advance.py) unless a phase says otherwise -- then holds each
kernel against its plain PyTorch version on the card at the shapes of those
paths:

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
     fsp_tol 1e-4, krylov_tol 1e-10), and ``ge5d`` at real size to t=2
     through the library's callable and through
     ``models/ge5d_model.input`` (separable, ``box_stencil``), which must
     agree, each in at most 2^23 cells; the CUSTOMPROP and library ge5d
     solves keep the last input they gave ``direct_stencil`` (one device
     copy of x per matvec) for phase 7;
  4. ``[sharded]``: the Goutsias solve of phase 2 row-sharded through
     ``solve_cme_box(..., mesh=...)`` in spawned ranks (one card per rank
     with NCCL when two or more cards are visible, up to 4; otherwise 2
     gloo ranks on ``cuda:0``), held against the one-rank solve of phase 2,
     with the cost of one all_reduce and one halo swap, and once more with
     rank 0 under torch.profiler (collective counts, the largest device
     items);
     The ranks then run the same solve with ``use_halo=False``
     (``[sharded-gather]``: halo_stencil with both halos cut from an
     all_gather), which must take the one-rank solve's steps and matvecs;
  4a. ``[sharded-direct]``: the library ge5d of phase 3 (a Python
     callable, so ``direct_stencil`` on each rank's rows with halos) to
     t=2, row-sharded the same way, held against the one-card solve
     (same box, L1 <= 2 x fsp_tol);
  4b. ``[table]``: the table backend (``solve_cme``: a sorted state table
     grown by SSA walks on the card and 1-step rounds, the gather-ELL
     operator) on toggle t=1000 and Goutsias t=10, each through the gate
     and within 2 x fsp_tol of the box solve of phase 2, and Goutsias t=30,
     the first horizon the box cannot reach (2^24 cells); every operator
     tensor, w and the active mask of every segment must be on the card.
     This path launches no stencil kernel: its matvec is torch ops (the
     JAX package computes it outside any Pallas kernel), counted by
     ``ops/spmv.py``'s ``CALLS`` and timed in ``[ell]``;
     ``[sharded-table]``: its Goutsias t=30 row-sharded over spawned ranks
     (``CmeSolver(mesh=...)``), within 2 x fsp_tol of the one-rank solve,
     and the sharded ELL matvec timed with its all_gather; ``[pencil]``:
     the same solve with ``table_operator="pencil"`` against the ELL one,
     and ``pencil_matvec`` timed against the ELL SpMV on its final states;
  5. off the counted paths: ``[fused]``, the toggle t=1000 of phase 2 in
     the stepwise loop beside the fused one, and a birth-death model whose
     segments of 5 steps end on their budget and shrink the box, held
     against its closed form and against the same solve on the CPU (the
     first step where their records part is printed); ``[profile]``,
     device-busy share and device-to-host copies and syncs per attempted
     step of toggle t=5 in both loops (box and table backends), Goutsias
     t=10, toggle_programmatic t=5 and the library ge5d;
  5b. ``[step]``: the ``expm_pade`` kernel (csrc/expm_pade.cu, every
     attempted step's Padé exponential) vs its plain version on
     Hessenbergs that the toggle and Goutsias solves hand it (mx near 12,
     32 and 64) and on a 100-column one from the toggle solve's end (mx =
     102), with ``torch.linalg.matrix_exp`` on the same block as the
     yardstick and the bound of one SM (the kernel is one thread block)
     beside the card's; phase 2's toggle t=1000 prints its mx histogram
     and its exponentials' summed kernel time (CUDA events around each
     call, read after the solve) beside its wall; the Arnoldi columns
     replayed as CUDA graphs (krylov/graphs.py) against the same columns
     run eagerly, bit for bit, on the final geometries of those solves.
     ``[profile]`` also counts
     the matvecs that ran after a breakdown, and fails if the one-card
     fused toggle or toggle_programmatic t=5 shows more than
     ``MAX_SYNCS_PER_STEP`` host syncs per attempted step;
  6. ``[kernels]``: ``box_stencil`` vs its plain version at three box
     geometries (the 2^22-cell Goutsias box, a 512x512 toggle box, a
     128-cell box smaller than one thread block) in float64 and float32,
     and on the final mask and w of the toggle and Goutsias solves of
     phase 2 (the kernel's inputs on that path: about 24% and 1.4% of
     their boxes active);
  7. ``[direct]``: ``direct_stencil`` vs its plain version (bit for bit in
     float64) on the 2^22-cell Goutsias box (also against ``box_stencil``:
     the model is separable), a 512x512 ``toggle_programmatic`` box and
     the box the ge5d solve reached, in float64 and float32, and on the
     last matvec input of the CUSTOMPROP toggle and ge5d solves of phase 3;
  8. ``[halo]``: ``halo_stencil`` vs its plain version on every row shard
     of the 2^22-cell Goutsias box and of the box the Goutsias solve of
     phase 2 ended in (the one [sharded] runs), each cut into 1, 2 and 4
     shards on one card (halos cut from the global vector), float64 and
     float32, and the concatenated shards vs ``box_stencil`` on the whole
     vector (bit for bit), with the times per shard beside
     ``box_stencil``'s;
  8b. ``[direct-halo]``: ``direct_stencil`` on every row shard of the
     2^23-cell box the ge5d solve reached, cut into 1, 2 and 4 shards on
     one card (each shard's pack from its global cells, halos cut from the
     global vector): kernel vs plain version per shard (float64 bit for
     bit), the concatenated shards vs the whole-box kernel (bit for bit),
     each shard's time, bound and CSR time;
  8c. ``[arnoldi]``: the Arnoldi column kernel (csrc/arnoldi_column.cu,
     everything of a column after its matvec) vs its plain version on the
     final states of the toggle and Goutsias solves of phase 2, float64
     and float32, qiop = 2: V[j] and H's column within 1e-13 / 1e-5 of
     their largest entry and the status exactly; its time eager and in a
     CUDA graph beside the plain version's and its bound; every solve
     path's columns and avnorms go through it (launches >= nmult in every
     solve and every rank);
  9. ``[ell]``: the table path's gather-ELL SpMV on the last operator and
     final w of the Goutsias t=30 solve of 4b: its time, its bound (the
     bytes it needs over 3.35 TB/s), one CSR SpMV of the same operator
     and the SpMV calls on the table path;
  10. ``[bench]``: ``kfs-torch bench --scale 64`` in a subprocess: the
     stencil kernels (``box_stencil`` and ``direct_stencil``, float64
     and float32) in 400 chained matvecs on the 4,194,304-cell Goutsias
     box against the stored-CSR memory roofline; its JSON line and each
     variant's line (µs per matvec, both rooflines, launches).

Every solve line also prints the breakdown steps the stepper took again
(krylov/stepper.py ``RETAKES``, by cause).  Toggle t=1000, box, in both
loops, must end off the FSP criterion's ceiling: wsum <= 1 + 1e-6.

``--table-flagship`` runs the reference's Goutsias horizon, t=300, on the
table backend alone, in the default fused loop (iflag 0 and wsum >= 1 -
1e-6; counts and peak memory beside the JAX package's record), and times
the pencil matvec against the ELL SpMV on its final states.
``--sharded-only`` runs [sharded], [sharded-direct] and [sharded-table]
with the one-rank solves they are held against.

Every line of 6-8 gives the kernel's time, its plain version's, its bound
(the bytes the function needs on this run's data over 3.35 TB/s: the
mask and y everywhere, x and D or the fields only at active cells; or
operations over the peak rate), its launches on the solve paths, and the time of one PyTorch
call that computes the same y (a CSR SpMV of the masked generator, built
from the kernel's operands; the port never calls it).  Inputs of the
kernels meet their contract ``supp(x) ⊆ mask``.

Each solve path (2, 3, 4, 4a, 4b and the pencil) runs with the kernels'
launch counts set to 0 just before it and read just after (in each rank,
for the sharded ones); these counts, and only these, are the kernels'
launches (the table paths must show none).  Each phase
prints its own lines with its wall time.  Any failure raises and exits
non-zero.  The last lines are a JSON record of the kernels, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
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
#: tensor cores (NVIDIA's data sheet): the stencils' bounds (their work is
#: elementwise)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
#: the float64 tensor cores' peak (the same data sheet): the bound of
#: expm_pade, whose work is dense float64 matrix products and an LU
PEAK_FLOPS_F64_MMA = 67e12
#: its streaming multiprocessors: expm_pade runs in one thread block, on
#: one of them
SM_COUNT = 132
#: NVLink between two cards of the host, each way (the same data sheet)
NVLINK_BYTES_PER_S = 450e9

#: the ge5d scenario of tests/test_models_e2e.py (x0 = 0, fsp_tol 1e-4,
#: krylov_tol 1e-8, box_min_log2 2) at its horizon; the fused loop keeps
#: the box within max_box_volume (2^23 cells) to there, where the stepwise
#: loop of both packages overflows it after t of about 1.26
GE5D_T = 2.0


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


def _bound(nbytes, flops, dt, peak=None):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``flops`` of type ``dt`` (at ``peak``
    operations per second where given, else at ``PEAK_FLOPS``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (peak or PEAK_FLOPS[str(dt)[6:]])
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
          f"halo_stencil, direct mode for direct_stencil; expm_pade) built "
          f"in {info.seconds:.2f} s (one nvcc per source, in parallel) -> "
          f"{info.path}")
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
    the last (mask, x) it gave the kernel at each box volume: the kernel's
    input on that solve path.  Each call copies mask and x on the card into
    buffers kept here for its volume (no host sync).  A call made while a
    CUDA graph is captured (krylov/graphs.py: the Arnoldi columns on one
    card) records the copies in the graph, so every replay keeps its input
    too; the buffers live as long as this object, so no graph writes freed
    memory."""

    def __init__(self, name):
        self.name = name
        self.buffers = {}

    def __enter__(self):
        import torch

        from krylovfspssa_tpu_torch.ops import stencil_cuda

        kernel = getattr(stencil_cuda, self.name)

        def keep_last(pack, mask, x):
            key = x.numel()
            if key not in self.buffers:
                self.buffers[key] = (torch.empty_like(mask),
                                     torch.empty_like(x))
            bm, bx = self.buffers[key]
            bm.copy_(mask)
            bx.copy_(x)
            return kernel(pack, mask, x)

        self._kernel = kernel
        setattr(stencil_cuda, self.name, keep_last)
        return self

    def __exit__(self, *exc):
        from krylovfspssa_tpu_torch.ops import stencil_cuda

        setattr(stencil_cuda, self.name, self._kernel)
        return False

    def inputs(self, volume):
        """The last (mask, x) at ``volume`` cells (the final box's: the
        solve's last matvec ran there), moved to the host; frees the
        buffers."""
        if volume not in self.buffers:
            raise AssertionError(f"no input of {self.name} at {volume} "
                                 "cells")
        mask, x = self.buffers[volume]
        out = mask.cpu(), x.cpu()
        self.buffers = {}
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


#: the stencil kernels (one is the matvec of every box solve; the table
#: paths launch none); ``expm_pade`` runs in every solve on the card
STENCILS = ("box_stencil", "direct_stencil", "halo_stencil")


def _launches() -> dict:
    from krylovfspssa_tpu_torch.krylov import arnoldi
    from krylovfspssa_tpu_torch.ops import expm, stencil_cuda

    return {"box_stencil": stencil_cuda.LAUNCHES,
            "direct_stencil": stencil_cuda.DIRECT_LAUNCHES,
            "halo_stencil": stencil_cuda.HALO_LAUNCHES,
            "expm_pade": expm.LAUNCHES,
            "arnoldi_column": arnoldi.LAUNCHES}


def _reset_launches():
    from krylovfspssa_tpu_torch.krylov import arnoldi
    from krylovfspssa_tpu_torch.ops import expm, stencil_cuda

    stencil_cuda.LAUNCHES = 0
    stencil_cuda.DIRECT_LAUNCHES = 0
    stencil_cuda.HALO_LAUNCHES = 0
    expm.LAUNCHES = 0
    arnoldi.LAUNCHES = 0


def _check_columns(tag, launches, nmult):
    """Every Arnoldi column and avnorm of a solve on the card went through
    csrc/arnoldi_column.cu: its launches (one per column and avnorm
    enqueued) are at least the solve's nmult (the columns up to each
    breakdown, plus the avnorms)."""
    if launches["arnoldi_column"] < nmult:
        raise AssertionError(f"{tag}: {launches['arnoldi_column']} "
                             f"arnoldi_column launches < nmult {nmult}")


def _reset_retakes():
    from krylovfspssa_tpu_torch.krylov import stepper

    for k in stepper.RETAKES:
        stepper.RETAKES[k] = 0


def _retakes() -> dict:
    """The breakdown steps the stepper took again since the last reset, by
    cause (krylov/stepper.py ``RETAKES``)."""
    from krylovfspssa_tpu_torch.krylov import stepper

    return dict(stepper.RETAKES)


def _any_stencil(launches) -> bool:
    return any(launches[k] for k in STENCILS)


@contextlib.contextmanager
def _spied(solver, name, spy):
    """While active, ``solver.<name>`` is ``spy(inner)`` of the method
    (the wrapper goes with the block: it refers back to the solver, and
    the cycle would keep the solver's device memory until a collection)."""
    setattr(solver, name, spy(getattr(solver, name)))
    try:
        yield
    finally:
        delattr(solver, name)


def _counting_segments(solver):
    """Count the fused segments ``solver`` runs, in ``solver.segments``."""
    solver.segments = 0

    def spy(inner):
        def advance(box, growable):
            adv = inner(box, growable)

            def counted(*args):
                solver.segments += 1
                return adv(*args)
            return counted
        return advance

    return _spied(solver, "_advance", spy)


def _solve(model, t, x0, fsp_tol, krylov_tol, config=None):
    """One solve on the card; returns (solver, result, launches of each
    kernel during the solve, wall seconds).  ``solver.segments`` is the
    number of fused segments (0 in the stepwise loop)."""
    import torch

    from krylovfspssa_tpu_torch import BoxCmeSolver

    solver = BoxCmeSolver(model, config, device="cuda")
    _reset_retakes()
    before = _launches()
    t0 = time.perf_counter()
    with _counting_segments(solver):
        res = solver.solve(t, x0, fsp_tol=fsp_tol, krylov_tol=krylov_tol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in _launches().items()}
    return solver, res, launches, wall


def _check_solve(tag, solver, res, launches, wsum_lo, wsum_hi,
                 kernel="box_stencil"):
    """The correctness gate of one solve; every matvec went through
    ``kernel`` and none through another stencil kernel, every exponential
    through ``expm_pade``, and every Arnoldi column through
    ``arnoldi_column``."""
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
    other = sum(launches[k] for k in STENCILS if k != kernel)
    if other:
        raise AssertionError(f"{tag}: {launches} — expected only {kernel}")
    if launches["expm_pade"] < s.nexph:
        raise AssertionError(f"{tag}: {launches['expm_pade']} expm_pade "
                             f"launches < nexph {s.nexph}")
    _check_columns(tag, launches, s.nmult)


def _print_solve(tag, solver, res, launches, wall):
    s = res.stats
    loop = (f"fused, {solver.segments} segments" if solver.config.fused_steps
            else "stepwise")
    print(f"[{tag}] ({loop}) nstep {s.nstep} nmult {s.nmult} "
          f"nreject {s.nreject} "
          f"nexph {s.nexph} expansions {s.n_expansions} drops {s.n_drops} "
          f"fsp {s.final_fsp_size} box {res.box.shape} vol {res.box.volume} "
          f"m_eff {solver.m_eff(res.box)} wsum {res.wsum:.10f} "
          f"retakes {_retakes()} launches {launches} wall {wall:.2f} s")


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


TOGGLE = (1000.0, [[0, 0]], 1e-4, 1e-10)
#: toggle t=1000 must end off the FSP criterion's ceiling (1 + fsp_tol at
#: t_out): a breakdown step that gains mass is taken again
#: (krylov/stepper.py), so the solve keeps its mass within this of 1
TOGGLE_MAX_GAIN = 1e-6


def _check_toggle(tag, res):
    """toggle t=1000 off the criterion's ceiling.  Its step count is
    printed, not gated: it is set by the time of the first happy
    breakdown under the scaled threshold, which moves with round-off
    (PERF.md §6)."""
    s = res.stats
    print(f"[{tag}] toggle t=1000: nstep {s.nstep} nmult {s.nmult} wsum "
          f"{res.wsum!r} retakes {_retakes()} (limit: wsum <= 1 + "
          f"{TOGGLE_MAX_GAIN:g})")
    if not res.wsum <= 1 + TOGGLE_MAX_GAIN:
        raise AssertionError(f"{tag}: toggle t=1000 ends at wsum "
                             f"{res.wsum!r}, on the criterion's ceiling")


def phase_toggle():
    """Returns the solve's result.  Each exponential of the solve is
    bracketed by CUDA events (read after it): the mx histogram and the
    summed expm_pade time print beside the wall."""
    from krylovfspssa_tpu_torch.models.library import toggle_file_model

    with expm_spy() as timed:
        solver, res, launches, wall = _solve(toggle_file_model(), *TOGGLE)
    _print_solve("toggle", solver, res, launches, wall)
    _check_solve("toggle", solver, res, launches, 1 - 1e-4, 1 + 1e-4)
    _check_toggle("toggle", res)
    ms, hist = _expm_summary(timed)
    s = res.stats
    print(f"[toggle] expm_pade: {len(timed)} calls (nexph {s.nexph}), mx "
          f"by tile (8 ceil(mx / 8): calls) {hist}, summed kernel "
          f"{ms:.1f} ms (events around each call) of the solve's "
          f"{wall:.2f} s wall; nstep {s.nstep} nmult {s.nmult}")
    return res


def _birth_death_exact(n_max, x0, kp, kd, t):
    """P(X(t) = n), n = 0..n_max, of ``0 -> X`` at kp and ``X -> 0`` at
    kd*X from X(0) = x0: the survivors of x0 are Binomial(x0, e^{-kd t}),
    the newcomers Poisson(kp/kd (1 - e^{-kd t})), independent."""
    import math

    q = math.exp(-kd * t)
    binom = np.array([math.comb(x0, k) * q ** k * (1 - q) ** (x0 - k)
                      for k in range(x0 + 1)])
    lam = kp / kd * (1 - q)
    pois = np.empty(n_max + 1)
    pois[0] = math.exp(-lam)
    for k in range(1, n_max + 1):
        pois[k] = pois[k - 1] * lam / k
    return np.convolve(binom, pois)[:n_max + 1]


#: the integer fields of a step record, which two runs of one trajectory
#: share exactly
RECORD_INTS = ("nstep", "fsp_size", "m", "advanced", "expanded", "dropped")


def _first_parting(a, b):
    """Index of the first step record whose integer fields differ between
    the lists ``a`` and ``b`` (or where one ends), None if they agree."""
    for i, (ra, rb) in enumerate(zip(a, b)):
        if any(getattr(ra, k) != getattr(rb, k) for k in RECORD_INTS):
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _record_line(r) -> str:
    return ", ".join(f"{k} {getattr(r, k)}" for k in
                     (*RECORD_INTS, "t_step", "t_now", "wsum", "err_loc"))


def phase_fused(fused):
    """[fused]: toggle t=1000 in the stepwise loop beside ``fused`` (the
    default fused solve of phase 2), both through the gate and within
    2 * fsp_tol of each other; models/birth_death_model.input with
    ``max_steps_per_call=5``, which must shrink its box and stay within
    2 * fsp_tol of the closed form, beside the same solve on the CPU."""
    from krylovfspssa_tpu_torch import BoxCmeSolver, SolverConfig, load_model
    from krylovfspssa_tpu_torch.models.library import toggle_file_model

    t0 = time.perf_counter()
    solver, res, launches, wall = _solve(
        toggle_file_model(), *TOGGLE, SolverConfig(fused_steps=False))
    _print_solve("fused", solver, res, launches, wall)
    _check_solve("fused: stepwise toggle", solver, res, launches,
                 1 - 1e-4, 1 + 1e-4)
    _check_toggle("fused", res)
    l1 = _l1(res, fused)
    print(f"[fused] toggle t=1000: stepwise nstep {res.stats.nstep} nmult "
          f"{res.stats.nmult} wall {wall:.2f} s, fused nstep "
          f"{fused.stats.nstep} nmult {fused.stats.nmult}; L1 {l1:.3e} "
          f"(limit {2 * TOGGLE[2]:g})")
    if not l1 <= 2 * TOGGLE[2]:
        raise AssertionError(f"fused and stepwise toggle differ: L1 {l1:.3e}")

    # X from 200 down to its steady-state mean kp/kd = 10
    model = load_model(Path(__file__).resolve().parent / "models"
                       / "birth_death_model.input")
    model.reset_parameters([1.0, 0.1])
    shrinks = []

    def spy(inner):
        def counted(box, *arrays):
            out = inner(box, *arrays)
            if out[0] is not box:
                shrinks.append(out[0].shape)
            return out
        return counted

    probe = BoxCmeSolver(model, SolverConfig(max_steps_per_call=5),
                         device="cuda")
    _reset_retakes()
    before = _launches()
    t1 = time.perf_counter()
    with _spied(probe, "_shrink_if_loose", spy), _counting_segments(probe):
        r = probe.solve(50.0, [[200]], fsp_tol=1e-6, krylov_tol=1e-10)
    bd_wall = time.perf_counter() - t1
    bd_launches = {k: v - before[k] for k, v in _launches().items()}
    _print_solve("fused", probe, r, bd_launches, bd_wall)
    print(f"[fused] birth-death budget 5: shrinks {shrinks}, final box "
          f"{r.box.shape}, fsp {r.stats.final_fsp_size} (JAX fused loop on "
          f"a CPU: 58 steps, 3 shrinks, box (64,)); phase wall "
          f"{time.perf_counter() - t0:.2f} s")
    _check_solve("fused: birth-death", probe, r, bd_launches, 1 - 1e-6,
                 1 + 1e-6)
    if not shrinks:
        raise AssertionError("birth-death budget 5: the box never shrank")

    n_max = int(r.states[:, 0].max()) + 400
    exact = _birth_death_exact(n_max, 200, 1.0, 0.1, 50.0)
    got = np.zeros(n_max + 1)
    got[r.states[:, 0]] = r.probabilities
    l1 = float(np.abs(got - exact).sum())
    cpu = BoxCmeSolver(model, SolverConfig(max_steps_per_call=5),
                       device="cpu").solve(50.0, [[200]], fsp_tol=1e-6,
                                           krylov_tol=1e-10)
    cpu_l1 = _l1(r, cpu)
    print(f"[fused] birth-death budget 5: L1 to the closed form {l1:.3e} "
          f"(limit {2e-6:g}); the same solve on the CPU: nstep "
          f"{cpu.stats.nstep} box {cpu.box.shape} fsp "
          f"{cpu.stats.final_fsp_size}, L1 card vs CPU {cpu_l1:.3e}")
    i = _first_parting(r.stats.records, cpu.stats.records)
    if i is None:
        print("[fused] birth-death budget 5: card and CPU records agree in "
              f"every integer field ({len(r.stats.records)} steps)")
    else:
        for where, recs in (("card", r.stats.records),
                            ("cpu", cpu.stats.records)):
            for j in range(max(i - 1, 0), min(i + 2, len(recs))):
                print(f"[fused] birth-death records part at step index {i}"
                      f": {where} [{j}] {_record_line(recs[j])}")
    if not l1 <= 2e-6:
        raise AssertionError(f"birth-death budget 5: L1 to the closed form "
                             f"{l1:.3e} > 2e-6")


def _device_us(e) -> float:
    """Device time of a kernel or copy event; 0 for host-side ops (an aten
    op also carries the time of the kernels it launched, which would count
    them twice)."""
    from torch.autograd import DeviceType

    if e.device_type != DeviceType.CUDA:
        return 0.0
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


@contextlib.contextmanager
def _extensions():
    """While active, every Arnoldi extension of the stepper is kept as
    (jold, m, its state); ``wasted(ext)`` is then the number of matvecs
    that ran after a breakdown (launched, and not in nmult)."""
    from krylovfspssa_tpu_torch.krylov import stepper

    inner = stepper.arnoldi_extend
    kept = []

    def spy(matvec, V, H, jold, m, *rest, **kw):
        st = inner(matvec, V, H, jold, m, *rest, **kw)
        kept.append((jold, m, st.breakdown, st.nmult))
        return st

    stepper.arnoldi_extend = spy
    try:
        yield kept
    finally:
        stepper.arnoldi_extend = inner


def _wasted(kept):
    """(matvecs run after a breakdown, extensions that broke down, all
    extensions) of the kept extensions (reads them once, after the
    solve)."""
    import torch

    if not kept:
        return 0, 0, 0
    brk = torch.stack([k[2] for k in kept]).cpu().numpy()
    nmult = torch.stack([k[3] for k in kept]).cpu().numpy()
    launched = np.array([m - jold + 2 for jold, m, _, _ in kept])
    return int((launched - nmult).sum()), int(brk.sum()), len(kept)


def _profile(tag, args, solve=None):
    """Device-busy and host-synchronisation shares of one solve, and its
    device-to-host copies and synchronisations per attempted step (per
    step record); returns the syncs per attempted step.  The solve runs
    once plainly (its wall is the denominator; the matvecs that ran after
    a breakdown are counted there) and once under torch.profiler (kernel
    times and the counts of host syncs and copies; the profiler slows the
    host, not the kernels).  ``solve`` is :func:`_solve` (the box backend)
    unless given."""
    from torch.profiler import ProfilerActivity, profile

    solve = solve or _solve
    with _extensions() as kept:
        res, wall = solve(*args)[1::2]
    wasted, broke, ext = _wasted(kept)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = solve(*args)[3]
    events = prof.key_averages()
    dev_us = sum(_device_us(e) for e in events)
    syncs = [e for e in events if e.key == "cudaStreamSynchronize"]
    n_sync = sum(e.count for e in syncs)
    n_d2h = sum(e.count for e in events if e.key.startswith("Memcpy DtoH"))
    attempts = max(len(res.stats.records), 1)
    blocked_us = sum(e.cpu_time_total for e in events
                     if e.key in ("cudaStreamSynchronize", "cudaMemcpyAsync"))
    print(f"[profile] {tag}: {wasted} matvecs ran after a breakdown "
          f"({broke} of {ext} Arnoldi extensions broke down; nmult "
          f"{res.stats.nmult})")
    if dev_us == 0.0:
        print(f"[profile] {tag}: no device time in the trace; busy and "
              f"sync shares not measured (wall {wall:.3f} s)")
        return n_sync / attempts
    print(f"[profile] {tag}: wall {wall:.3f} s (nmult {res.stats.nmult}), "
          f"kernel time {dev_us / 1e6:.3f} s = device busy "
          f"{100 * dev_us / 1e6 / wall:.1f}% of that wall; {n_sync} host "
          f"syncs ({1e6 * wall / max(n_sync, 1):.0f} us of wall per sync); "
          f"under the profiler (wall {wall_prof:.3f} s) the host was "
          f"blocked in syncs/D2H copies {blocked_us / 1e6:.3f} s; per "
          f"attempted step ({attempts}): {n_d2h / attempts:.1f} D2H copies, "
          f"{n_sync / attempts:.1f} syncs")
    for e in sorted(events, key=lambda e: -_device_us(e))[:6]:
        print(f"[profile]   {e.key[:60]:60s} {_device_us(e) / 1e3:9.1f} ms "
              f"x{e.count}")
    return n_sync / attempts


#: host syncs per attempted step allowed on the one-card box solves whose
#: Arnoldi columns replay as CUDA graphs (one read per attempt and per FSP
#: evaluation, the fused loop's reads after a drop or an expansion)
MAX_SYNCS_PER_STEP = 8


GOUTSIAS = (10.0, [[2, 6, 0, 2, 0, 0]], 1e-6, 1e-8)


def phase_profiles():
    """[profile] of the solves of phases 2 and 3, each run again off the
    counted paths.  Toggle and toggle_programmatic in a t=5 window (a trace
    of all of toggle t=1000 holds ~10^6 events and takes minutes to
    reduce), toggle in each loop."""
    from krylovfspssa_tpu_torch import SolverConfig
    from krylovfspssa_tpu_torch.models.library import (
        ge5d_model,
        goutsias_model,
        toggle_file_model,
        toggle_programmatic_model,
    )

    gated = {}
    for loop, config in (("fused", None),
                         ("stepwise", SolverConfig(fused_steps=False))):
        gated[f"toggle t=5 {loop}"] = _profile(
            f"toggle t=5 {loop}",
            (toggle_file_model(), 5.0, [[0, 0]], 1e-4, 1e-10, config))
    del gated["toggle t=5 stepwise"]  # its op_info reads every step
    _profile("goutsias t=10", (goutsias_model(), *GOUTSIAS))
    gated["toggle_programmatic t=5"] = _profile(
        "toggle_programmatic t=5",
        (toggle_programmatic_model(), 5.0, [[0, 0]], 1e-4, 1e-10))
    for loop, config in (("fused", None),
                         ("stepwise", SolverConfig(fused_steps=False))):
        _profile(f"table toggle t=5 {loop}",
                 (toggle_file_model(), 5.0, [[0, 0]], 1e-4, 1e-10, config),
                 _solve_table)
    _profile("ge5d-library t=%g" % GE5D_T,
             (ge5d_model(), GE5D_T, [[0, 0, 0, 0, 0]], 1e-4, 1e-8,
              SolverConfig(box_min_log2=2)))
    for tag, per_step in gated.items():
        if per_step is not None and per_step > MAX_SYNCS_PER_STEP:
            raise AssertionError(f"[profile] {tag}: {per_step:.1f} host "
                                 f"syncs per attempted step > "
                                 f"{MAX_SYNCS_PER_STEP}")


@contextlib.contextmanager
def expm_spy(keep=False):
    """While active, every exponential a stepper asks for is bracketed by
    two CUDA events on the current stream (nothing is read back during
    the solve): yields a list of (start, end, mx, inputs) to read after
    it, where inputs is the call's (Hbar, mx, t, ideg) if ``keep``, else
    None (the stepper never writes an Hbar again, so they are kept by
    reference)."""
    import torch

    from krylovfspssa_tpu_torch.krylov import stepper

    inner = stepper.expm_pade
    calls = []

    def spy(H, mx, t, ideg=6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(H, mx, t, ideg)
        b.record()
        calls.append((a, b, mx, (H, mx, t, ideg) if keep else None))
        return out

    stepper.expm_pade = spy
    try:
        yield calls
    finally:
        stepper.expm_pade = inner


def _expm_summary(calls):
    """(summed ms, {8 ceil(mx / 8): calls}) of expm_spy's calls."""
    import collections

    import torch

    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b, _, _ in calls)
    hist = collections.Counter(8 * -(-int(mx) // 8) for _, _, mx, _ in calls)
    return ms, dict(sorted(hist.items()))


def _expm_flops(n, ns, ideg=6) -> float:
    """The kernel's float64 operations at block n with ns squarings: the
    products of A2, the Horner steps and the odd part, the LU with n
    right-hand sides and the ns squarings (2 n^3 each)."""
    return (2.0 * (ideg + 1) + 2.0 * ns + 8.0 / 3.0) * n ** 3


def _expm_case(tag, H, mx, t):
    """expm_pade (kernel) vs expm_pade_plain on one Hessenberg on the card:
    relative error, kernel / plain / torch.linalg.matrix_exp times, bound."""
    import torch

    from krylovfspssa_tpu_torch.ops import expm

    dev = H.device
    mx_d = torch.tensor(mx, dtype=torch.int64, device=dev)
    t_d = torch.tensor(t, dtype=torch.float64, device=dev)
    Ek, hk, nk = expm.expm_pade(H, mx_d, t_d)
    Ep, hp, np_ = expm.expm_pade_plain(H, mx, t)
    torch.cuda.synchronize()
    scale = float(torch.max(torch.abs(Ep)))
    err = float(torch.max(torch.abs(Ek - Ep)))
    ns = int(np_)
    if int(nk) != ns or not abs(float(hk) - float(hp)) <= 1e-12 * float(hp):
        raise AssertionError(f"[step] expm {tag}: hnorm/ns {float(hk)}/"
                             f"{int(nk)} vs plain {float(hp)}/{ns}")
    if not err <= F64_RTOL * scale:
        raise AssertionError(f"[step] expm {tag} mx={mx}: kernel vs plain "
                             f"{err:.3e} > {F64_RTOL:g} x {scale:.3e}")
    block = (t * H[:mx, :mx]).contiguous()
    lib_ms = _time_ms(torch.linalg.matrix_exp, block)
    ms = _time_ms(expm.expm_pade, H, mx_d, t_d)
    plain_ms = _time_ms(expm.expm_pade_plain, H, mx, t)
    row = _row(err, ms, plain_ms,
               _bound(8 * (mx * mx + H.numel()), _expm_flops(mx, ns),
                      torch.float64, PEAK_FLOPS_F64_MMA), lib_ms, None)
    # the kernel is one thread block: one SM's share of the tensor cores
    sm_bound_ms = _expm_flops(mx, ns) / (PEAK_FLOPS_F64_MMA / SM_COUNT) * 1e3
    row.update(mx=mx, ns=ns, max_rel_err=err / scale,
               sm_bound_ms=sm_bound_ms)
    print(f"[step] expm_pade {tag}: mx={mx} ns={ns} hnorm {float(hp):.3e} "
          f"max rel err {err / scale:.3e} (limit {F64_RTOL:g}); kernel "
          f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
          f"torch.linalg.matrix_exp {lib_ms * 1e3:.1f} us (another "
          f"approximant: the yardstick only), bound {row['bound_ms'] * 1e3:.3f}"
          f" us ({row['bound_by']}; the card), one-SM bound "
          f"{sm_bound_ms * 1e3:.1f} us (operations at 1/{SM_COUNT} of the "
          f"float64 tensor cores' rate)")
    return row


def _columns(tag, model, res, m=30):
    """The Arnoldi extension on the final (mask, w) of ``res`` to column m,
    eagerly and through the column graphs (capture, then pure replays):
    V, H and the status equal bit for bit; µs per column each way."""
    import torch

    from krylovfspssa_tpu_torch import SolverConfig
    from krylovfspssa_tpu_torch.krylov.arnoldi import arnoldi_extend
    from krylovfspssa_tpu_torch.krylov.graphs import ColumnGraphs
    from krylovfspssa_tpu_torch.ops.stencil import select_stencil_matvec

    mask, w = _final_inputs(res)
    matvec = select_stencil_matvec(model, res.box, SolverConfig(),
                                   torch.float64, "cuda")
    tol = 1e-7

    def fresh(V=None, H=None):
        """A basis and Hessenberg as a step starts them (in place when
        given: a graph is keyed by their storage)."""
        if V is None:
            V = torch.empty((m + 2, w.numel()), dtype=torch.float64,
                            device="cuda")
            H = torch.empty((m + 2, m + 2), dtype=torch.float64,
                            device="cuda")
        V.zero_()
        H.zero_()
        V[0] = w / torch.linalg.vector_norm(w)
        return V, H

    def state(st):
        return torch.stack([st.breakdown.double(), st.mbrkdwn.double(),
                            st.avnorm, st.nmult.double()])

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / m * 1e6

    Ve, He = fresh()
    ste, eager_us = timed(lambda: arnoldi_extend(
        lambda x: matvec(mask, x), Ve, He, 1, m, 2, tol))
    graphs = ColumnGraphs(matvec, mask)
    graphs.load(mask, tol)
    runs = []
    Vg, Hg = fresh()
    for _ in range(2):  # the first captures, the second only replays
        fresh(Vg, Hg)
        stg, us = timed(lambda: arnoldi_extend(None, Vg, Hg, 1, m, 2, tol,
                                               graphs=graphs))
        same = (torch.equal(Vg, Ve) and torch.equal(Hg, He)
                and torch.equal(state(stg), state(ste)))
        if not same:
            raise AssertionError(f"[step] {tag}: graph-replayed columns "
                                 "differ from the eager columns")
        runs.append(us)
    if len(graphs) != m + 1:
        raise AssertionError(f"[step] {tag}: {len(graphs)} graphs for "
                             f"{m} columns and the avnorm matvec")
    print(f"[step] columns {tag} (box {res.box.shape}, m={m}): graph "
          f"replays equal the eager columns bit for bit (V, H, breakdown, "
          f"mb, avnorm, nmult); {len(graphs)} graphs; per column: eager "
          f"{eager_us:.1f} us, capture {runs[0]:.1f} us, replay "
          f"{runs[1]:.1f} us (host wall, synchronised)")


def phase_step(toggle_one, goutsias_one):
    """[step]: the expm_pade kernel vs its plain version on Hessenbergs of
    the toggle and Goutsias solves (run again off the counted paths) at mx
    near 12, 32 and 64, and at mx = 102 from a 100-column Arnoldi on the
    toggle solve's final state; the graph-replayed Arnoldi columns vs the
    eager ones on the final geometry of each solve.  Returns the mx~32
    row, the kernels JSON line's expm_pade entry, with every case under
    "cases" (toggle t=1000 spends most of its exponential time at mx of
    89 to 104: the mx=102 case)."""
    import torch

    from krylovfspssa_tpu_torch.krylov.arnoldi import arnoldi_extend
    from krylovfspssa_tpu_torch.models.library import (
        goutsias_model,
        toggle_file_model,
    )
    from krylovfspssa_tpu_torch.ops.stencil import select_stencil_matvec

    t0 = time.perf_counter()
    with expm_spy(keep=True) as kept:
        _solve(toggle_file_model(), 5.0, [[0, 0]], 1e-4, 1e-10)
        _solve(goutsias_model(), *GOUTSIAS)
    torch.cuda.synchronize()
    calls = [(H, int(mx), float(t)) for _, _, _, (H, mx, t, _) in kept]
    rows = {}
    for target in (12, 32, 64):
        H, mx, t = min(calls, key=lambda c: (abs(c[1] - target), -c[1]))
        rows[f"mx~{target}"] = _expm_case(f"solve mx~{target}", H, mx, t)
    # mx = 102: the Hessenberg of 100 columns on the toggle solve's end
    mask, w = _final_inputs(toggle_one)
    from krylovfspssa_tpu_torch import SolverConfig

    model = toggle_file_model()
    mv = select_stencil_matvec(model, toggle_one.box, SolverConfig(),
                               torch.float64, "cuda")
    MH = 102
    V = torch.zeros((MH, w.numel()), dtype=torch.float64, device="cuda")
    V[0] = w / torch.linalg.vector_norm(w)
    H = torch.zeros((MH, MH), dtype=torch.float64, device="cuda")
    st = arnoldi_extend(lambda x: mv(mask, x), V, H, 1, MH - 2, 2, 1e-7)
    if bool(st.breakdown):
        raise AssertionError("[step] the 100-column Arnoldi broke down")
    H[MH - 1, MH - 2] = 1.0
    # the solve's median step (its last one is a happy-breakdown step of
    # hundreds of time units, past what a 100-column Hessenberg holds)
    t_med = float(np.median([r.t_step for r in toggle_one.stats.records]))
    rows["mx=102"] = _expm_case("toggle final, 100 columns", H, MH, t_med)
    del V
    _columns("toggle", model, toggle_one)
    _columns("goutsias", goutsias_model(), goutsias_one)
    print(f"[step] wall {time.perf_counter() - t0:.2f} s")
    out = dict(rows["mx~32"])
    out["cases"] = rows
    return out


def phase_arnoldi(launches, finals):
    """[arnoldi]: the Arnoldi column kernel (csrc/arnoldi_column.cu, through
    ``arnoldi.column_update``) vs its plain version
    (``column_update_plain``) on the card, at the solves' qiop = 2, on
    column 3 of a basis grown by the solve's own matvec from the final w of
    each solve in ``finals`` ({name: (model, result)}), in float64 and
    float32: V[j] and the column of H within 1e-13 (float64) or 1e-5
    (float32) of their largest entry (the kernel and the plain version sum
    each dot in a different order; the plain float32 dot sums blocks of
    128 products in float32), the status exactly.  Each row gives the
    kernel's time launched eagerly and replayed from a CUDA graph (as the
    box backend runs it), the plain version's, and the bound: the bytes
    the column needs (w, v_{j-1} and v_j read, V[j] written: 32 vol bytes
    in float64) over 3.35 TB/s.  Returns the first solve's float64 row,
    with every case under "cases"."""
    import torch

    from krylovfspssa_tpu_torch import SolverConfig
    from krylovfspssa_tpu_torch.krylov import arnoldi
    from krylovfspssa_tpu_torch.ops.stencil import select_stencil_matvec

    t0 = time.perf_counter()
    j, qiop = 3, 2
    tol = torch.tensor(1e-7, dtype=torch.float64, device="cuda")
    rows = {}
    for name, (model, res) in finals.items():
        mask, x = _final_inputs(res)
        mv = select_stencil_matvec(model, res.box, SolverConfig(),
                                   torch.float64, "cuda")
        vol = x.numel()
        V = torch.zeros((j + 2, vol), dtype=torch.float64, device="cuda")
        H = torch.zeros((j + 2, j + 2), dtype=torch.float64, device="cuda")
        V[0] = x / torch.linalg.vector_norm(x)
        st = arnoldi.arnoldi_extend(lambda v: mv(mask, v), V, H, 1, j - 1,
                                    qiop, tol)
        if bool(st.breakdown):
            raise AssertionError(f"[arnoldi] {name}: the basis broke down")
        w64 = mv(mask, V[j - 1])
        for dt, rtol in ((torch.float64, 1e-13),
                         (torch.float32, F32_RTOL)):
            w = w64.to(dt)
            start = (V.to(dt), H.clone(), arnoldi.new_status("cuda"))
            kern = tuple(t.clone() for t in start)
            plain = tuple(t.clone() for t in start)
            before = arnoldi.LAUNCHES
            arnoldi.column_update(w, *kern, j, qiop, tol)
            arnoldi.column_update_plain(w, *plain, j, qiop, tol)
            torch.cuda.synchronize()
            if arnoldi.LAUNCHES != before + 1:
                raise AssertionError(f"[arnoldi] {name}: "
                                     f"{arnoldi.LAUNCHES - before} launches")
            errs = {}
            for what, a, b in (
                    ("V[j]", kern[0][j], plain[0][j]),
                    ("H", kern[1][j - qiop:j + 1, j - 1],
                     plain[1][j - qiop:j + 1, j - 1])):
                a, b = a.double(), b.double()
                errs[what] = float(torch.max(torch.abs(a - b))
                                   / torch.max(torch.abs(b)))
            same = (torch.equal(kern[2], plain[2])
                    and torch.equal(kern[0][:j], plain[0][:j]))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                arnoldi.column_update(w, *kern, j, qiop, tol)
            ms = _time_ms(arnoldi.column_update, w, *kern, j, qiop, tol)
            row = dict(
                max_rel_err=max(errs.values()), ms=ms,
                graph_ms=_time_ms(graph.replay),
                plain_ms=_time_ms(arnoldi.column_update_plain, w, *plain, j,
                                  qiop, tol),
                bound_ms=_bound((qiop + 2) * vol * w.element_size(), 0,
                                dt)[0],
                launches=launches, vol=vol)
            del graph
            tag = f"{name}-solve-final {str(dt)[6:]}"
            print(f"[arnoldi] {tag} vol={vol} j={j} qiop={qiop}: max rel "
                  f"err V[j] {errs['V[j]']:.3e}, H {errs['H']:.3e} (limit "
                  f"{rtol:g}); status equal {same}; kernel "
                  f"{row['ms'] * 1e3:.2f} us eager, "
                  f"{row['graph_ms'] * 1e3:.2f} us in a graph; plain "
                  f"{row['plain_ms'] * 1e3:.1f} us; bound "
                  f"{row['bound_ms'] * 1e3:.2f} us (bytes; "
                  f"{100 * row['bound_ms'] / row['graph_ms']:.0f}% of it in "
                  f"a graph); launches on the solve paths {launches}")
            if not (same and row["max_rel_err"] <= rtol):
                raise AssertionError(f"[arnoldi] {tag}: kernel disagrees "
                                     f"with the plain version: {errs}, "
                                     f"status and rows equal {same}")
            rows[tag] = row
    print(f"[arnoldi] wall {time.perf_counter() - t0:.2f} s")
    out = dict(next(iter(rows.values())))
    out["cases"] = rows
    return out


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
    mask, x = last.inputs(res.box.volume)
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
        geoms = solver.cached_geometries
        print(f"[{tag}] t={GE5D_T} peak device memory {peak:.2f} GiB{held}; "
              f"{len(geoms)} cached geometries "
              f"{sorted(geoms, key=np.prod)}")
        _check_solve(tag, solver, res, launches, 1 - fsp_tol, 1 + fsp_tol,
                     kernel=kernel)
        if not 1 << 20 <= res.box.volume <= 1 << 23:
            raise AssertionError(f"{tag}: box volume {res.box.volume} "
                                 "outside [2^20, 2^23]")
        results.append(res)
        del solver
    l1 = _l1(*results)
    print(f"[ge5d] library vs .input: L1 {l1:.3e} (limit {2 * fsp_tol:g})")
    if not l1 <= 2 * fsp_tol:
        raise AssertionError(f"ge5d library and .input solves differ: "
                             f"L1 {l1:.3e}")
    return lib, *captured, results[0]


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


def _direct_shard_csr(pack, mask):
    """direct_stencil's masked generator of a row-shard pack as a CSR
    matrix over the padded sources ``[left | x | right]`` (H cells each
    side): the library yardstick of [direct-halo], y = A @ xpad."""
    import torch

    H, n = pack.halo, pack.rows
    i = torch.nonzero(mask).squeeze(1)
    rows, cols, vals = [i], [H + i], [-pack.diag[i]]
    for k, off in enumerate(pack.meta.tolist()):
        u = pack.rates[k][i]
        j = i - off
        inside = (j >= 0) & (j < n)
        keep = (u != 0) & (~inside | mask[j.clamp(0, n - 1)])
        rows.append(i[keep])
        cols.append(H + j[keep])
        vals.append(u[keep])
    return _csr(rows, cols, vals, (n, n + 2 * H))


def phase_direct_halo(model, box, launches):
    """[direct-halo]: direct_stencil on every row shard of ``box`` (the
    2^23-cell box the ge5d solve reached) cut into P = 1, 2 and 4 shards
    on one card, each shard's pack built from its global cells and its
    halos cut from the global masked x (every face of the box active):
    kernel vs plain version per shard (bit for bit in float64, within
    F32_RTOL in float32), and the concatenated shards vs the whole-box
    direct_stencil, bit for bit in float64.  Each shard's time, bound
    (fields counted: the model is a Python callable) and CSR time.
    Returns {P: row} of float64 (worst error, median shard times, and
    each shard's times)."""
    import torch

    from krylovfspssa_tpu_torch.ops import stencil_cuda as sc
    from krylovfspssa_tpu_torch.ops.halo import halo_from_global

    t0 = time.perf_counter()
    out = {}
    R = model.n_reactions
    for dt, rtol in ((torch.float64, F64_RTOL), (torch.float32, F32_RTOL)):
        mask, x = _face_inputs(box, dt)
        whole_pack = sc.pack_direct_stencil(model, box, dt, "cuda")
        whole = sc.direct_stencil(whole_pack, mask, x)
        ms_whole = _time_ms(sc.direct_stencil, whole_pack, mask, x)
        del whole_pack
        scale = float(torch.max(torch.abs(whole)))
        item = x.element_size()
        for n_ranks in (1, 2, 4):
            L = box.volume // n_ranks
            shards, rows = [], []
            for r in range(n_ranks):
                z0 = r * L
                pack = sc.pack_direct_stencil(model, box, dt, "cuda", z0, L)
                halos = halo_from_global(x, z0, L, pack.halo)
                args = (pack, mask[z0:z0 + L], x[z0:z0 + L], *halos)
                y_k = sc.direct_stencil(*args)
                y_p = sc._direct_stencil_plain(*args)
                torch.cuda.synchronize()
                active = int(args[1].sum())
                nbytes = (_nbytes(args[1], args[2]) + active * item
                          + R * active * item + _nbytes(*halos))
                rows.append(_row(
                    float(torch.max(torch.abs(y_k - y_p))),
                    _time_ms(sc.direct_stencil, *args),
                    _time_ms(sc._direct_stencil_plain, *args),
                    _bound(nbytes, active * (3 * R + 1), dt),
                    _library(_direct_shard_csr(pack, args[1]),
                             torch.cat([halos[0], args[2], halos[1]]), y_k,
                             rtol, scale),
                    launches))
                shards.append(y_k)
                del pack
            bitwise = torch.equal(torch.cat(shards), whole)
            row = dict(rows[0], **{key: statistics.median(r[key]
                                                          for r in rows)
                                   for key in ("ms", "plain_ms", "bound_ms",
                                               "library_ms")})
            row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
            row["shard_ms"] = [r["ms"] for r in rows]
            row["shard_bound_ms"] = [r["bound_ms"] for r in rows]
            row["shard_library_ms"] = [r["library_ms"] for r in rows]
            per = {key: " ".join("%.2f" % (r[key] * 1e3) for r in rows)
                   for key in ("ms", "bound_ms", "library_ms")}
            print(f"[direct-halo] ge5d {tuple(box.shape)} {str(dt)[6:]} "
                  f"P={n_ranks} L={L} H={halos[0].numel()}: "
                  f"max_abs_err={row['max_abs_err']:.3e} vs plain (limit "
                  f"{rtol:g} x {scale:.3e}; float64 bit for bit), "
                  f"concatenated shards equal the whole-box direct_stencil "
                  f"bit for bit: {bitwise}; per shard kernel {per['ms']} us, "
                  f"bound {per['bound_ms']} us, CSR library "
                  f"{per['library_ms']} us; median {_us(row)}; whole-box "
                  f"direct_stencil {ms_whole * 1e3:.2f} us")
            exact = row["max_abs_err"] == 0.0 if dt == torch.float64 else (
                row["max_abs_err"] <= rtol * scale)
            if not (exact and (bitwise or dt != torch.float64)):
                raise AssertionError(
                    f"direct_stencil on shards disagrees at P={n_ranks} "
                    f"{dt}: {row['max_abs_err']:.3e} vs plain; shards equal "
                    f"the whole box: {bitwise}")
            if dt == torch.float64:
                out[n_ranks] = row
        del mask, x, whole
    print(f"[direct-halo] wall {time.perf_counter() - t0:.2f} s")
    return out


def _sharded_rank(mesh, args):
    """One rank of [sharded]: the Goutsias solve on this rank's rows, with
    this process's launch counts set to 0 just before it.  A t=1 solve
    first takes the fresh process's start-up (CUDA context, cuBLAS,
    communicators), so that the wall compares with phase 3's warm one, and
    a barrier starts every rank's clock together."""
    import torch

    from krylovfspssa_tpu_torch import BoxCmeSolver, SolverConfig
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
    profile = _rank_profile(mesh, args, res.box)
    # the same solve with use_halo=False: halo_stencil with both halos cut
    # from an all_gather of the vector, counted in its own window
    gathered = BoxCmeSolver(goutsias_model(),
                            SolverConfig(use_halo=False), mesh=mesh)
    mesh.barrier()
    _reset_launches()
    t0 = time.perf_counter()
    r2 = gathered.solve(args[0], args[1], fsp_tol=args[2],
                        krylov_tol=args[3])
    torch.cuda.synchronize(mesh.device)
    no_halo = dict(launches=_launches(), wall=time.perf_counter() - t0,
                   stats=(r2.stats.iflag, r2.stats.nstep, r2.stats.nmult,
                          r2.stats.nreject),
                   result=r2 if mesh.rank == 0 else None)
    return dict(
        rank=mesh.rank, device=str(mesh.device), dtype=str(solver.dtype),
        launches=launches, wall=wall, peak_gib=peak_gib, no_halo=no_halo,
        profile=profile,
        records=list(res.stats.records),
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
        _check_columns(f"[sharded] rank {o['rank']}", o["launches"], nmult)
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
    gathered = _check_no_halo(outs, one_rank)
    return total, gathered


def _check_no_halo(outs, one_rank):
    """The [sharded] ranks' use_halo=False solve: halo_stencil launches >=
    nmult in every rank and no other kernel, the one-rank solve's box and
    step counts, equal records on every rank, L1 <= 2 x fsp_tol to the
    one-rank solve.  Returns its launches summed over the ranks."""
    fsp_tol = GOUTSIAS[2]
    res = outs[0]["no_halo"]["result"]
    one = one_rank.stats
    for o in outs:
        nh = o["no_halo"]
        iflag, nstep, nmult, nreject = nh["stats"]
        print(f"[sharded-gather] rank {o['rank']} use_halo=False: nstep "
              f"{nstep} nmult {nmult} nreject {nreject} launches "
              f"{nh['launches']} wall {nh['wall']:.2f} s (one rank: nstep "
              f"{one.nstep} nmult {one.nmult})")
        if iflag != 0 or nh["launches"]["halo_stencil"] < nmult:
            raise AssertionError(f"use_halo=False rank {o['rank']}: iflag "
                                 f"{iflag}, {nh['launches']} < nmult {nmult}")
        _check_columns(f"[sharded-gather] rank {o['rank']}", nh["launches"],
                       nmult)
        if nh["launches"]["box_stencil"] or nh["launches"]["direct_stencil"]:
            raise AssertionError(f"use_halo=False launched another kernel: "
                                 f"{nh['launches']}")
        if (nstep, nmult) != (one.nstep, one.nmult):
            raise AssertionError(f"use_halo=False rank {o['rank']}: counts "
                                 f"{(nstep, nmult)} vs one rank "
                                 f"{(one.nstep, one.nmult)}")
    l1 = _l1(res, one_rank)
    print(f"[sharded-gather] wsum {res.wsum:.10f} box {res.box.shape}; L1 "
          f"to the one-rank solve {l1:.3e} (limit {2 * fsp_tol:g})")
    if res.box.shape != one_rank.box.shape or not l1 <= 2 * fsp_tol:
        raise AssertionError(f"use_halo=False solve differs: box "
                             f"{res.box.shape}, L1 {l1:.3e}")
    return {k: sum(o["no_halo"]["launches"][k] for o in outs)
            for k in outs[0]["launches"]}


def _mesh_devices(tag, max_ranks=4):
    """(devices, backend) of a spawned sharded phase: one card per rank
    with NCCL when two or more cards are visible (up to ``max_ranks``),
    else 2 gloo ranks on ``cuda:0``."""
    import torch

    cards = torch.cuda.device_count()
    if cards >= 2:
        devices = [f"cuda:{r}" for r in range(min(cards, max_ranks))]
        backend = "nccl"
    else:
        devices, backend = ["cuda:0", "cuda:0"], "gloo"
    print(f"[{tag}] {len(devices)} ranks, {backend}, on {devices} "
          f"({cards} cards visible)")
    return devices, backend


def _ge5d_args():
    from krylovfspssa_tpu_torch import SolverConfig

    return (GE5D_T, [[0, 0, 0, 0, 0]], 1e-4, 1e-8,
            SolverConfig(box_min_log2=2))


def _sharded_direct_rank(mesh):
    """One rank of [sharded-direct]: the library ge5d (a Python callable:
    direct_stencil on this rank's rows) to t=2, launch counts set to 0
    just before it and read just after."""
    import torch

    from krylovfspssa_tpu_torch import BoxCmeSolver
    from krylovfspssa_tpu_torch.models.library import ge5d_model

    t, x0, fsp_tol, krylov_tol, config = _ge5d_args()
    solver = BoxCmeSolver(ge5d_model(), config, mesh=mesh)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    mesh.barrier()
    _reset_launches()
    t0 = time.perf_counter()
    res = solver.solve(t, x0, fsp_tol=fsp_tol, krylov_tol=krylov_tol)
    torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - t0
    return dict(rank=mesh.rank, device=str(mesh.device),
                dtype=str(solver.dtype), launches=_launches(), wall=wall,
                peak_gib=torch.cuda.max_memory_allocated(mesh.device)
                / 2 ** 30,
                records=list(res.stats.records),
                stats=(res.stats.iflag, res.stats.nstep, res.stats.nmult),
                result=res if mesh.rank == 0 else None)


def phase_sharded_direct(one_rank):
    """[sharded-direct]: the library ge5d of phase 3 row-sharded through
    ``solve_cme_box(..., mesh=...)``; held against the one-card solve
    (same box, L1 <= 2 x fsp_tol).  Every rank launches direct_stencil at
    least nmult times and no other kernel.  Returns the launches summed
    over the ranks."""
    from krylovfspssa_tpu_torch.parallel.multihost import spawn

    t0 = time.perf_counter()
    devices, backend = _mesh_devices("sharded-direct")
    outs = spawn(_sharded_direct_rank, devices, backend=backend,
                 timeout_s=600)
    fsp_tol = _ge5d_args()[2]
    for o in outs:
        iflag, nstep, nmult = o["stats"]
        print(f"[sharded-direct] rank {o['rank']} on {o['device']}: nstep "
              f"{nstep} nmult {nmult} launches {o['launches']} wall "
              f"{o['wall']:.2f} s peak device memory {o['peak_gib']:.2f} GiB")
        if iflag != 0 or o["dtype"] != "torch.float64":
            raise AssertionError(f"sharded ge5d rank {o['rank']}: iflag "
                                 f"{iflag}, {o['dtype']}")
        if o["launches"]["direct_stencil"] < nmult:
            raise AssertionError(f"rank {o['rank']}: {o['launches']} "
                                 f"direct_stencil launches < nmult {nmult}")
        _check_columns(f"[sharded-direct] rank {o['rank']}", o["launches"],
                       nmult)
        if o["launches"]["box_stencil"] or o["launches"]["halo_stencil"]:
            raise AssertionError(f"rank {o['rank']} launched another "
                                 f"kernel: {o['launches']}")
        if o["records"] != outs[0]["records"]:
            raise AssertionError(f"rank {o['rank']}'s step records differ")
    res = outs[0]["result"]
    l1 = _l1(res, one_rank)
    print(f"[sharded-direct] ge5d t={GE5D_T:g}: wsum {res.wsum:.10f} box "
          f"{res.box.shape} vol {res.box.volume} nstep {res.stats.nstep} "
          f"nmult {res.stats.nmult}; one card: box {one_rank.box.shape} "
          f"nstep {one_rank.stats.nstep} nmult {one_rank.stats.nmult}; L1 "
          f"{l1:.3e} (limit {2 * fsp_tol:g}); wall "
          f"{time.perf_counter() - t0:.2f} s with spawning")
    if not (np.all(np.isfinite(res.probabilities))
            and 1 - fsp_tol <= res.wsum <= 1 + fsp_tol):
        raise AssertionError(f"sharded ge5d wsum {res.wsum}")
    if res.box.shape != one_rank.box.shape or not l1 <= 2 * fsp_tol:
        raise AssertionError(f"sharded ge5d differs from one card: box "
                             f"{res.box.shape} vs {one_rank.box.shape}, L1 "
                             f"{l1:.3e}")
    total = {k: sum(o["launches"][k] for o in outs)
             for k in outs[0]["launches"]}
    print(f"[sharded-direct path] launches (all ranks): {total}")
    return total


def _sharded_table_rank(mesh):
    """One rank of [sharded-table]: table Goutsias t=30 on this rank's rows
    (SpMV calls and stencil launches counted from 0 just before it), then
    the sharded ELL matvec (its all_gather included) timed on the last
    operator, back to back after a barrier."""
    import torch

    from krylovfspssa_tpu_torch import CmeSolver
    from krylovfspssa_tpu_torch.models.library import goutsias_model
    from krylovfspssa_tpu_torch.ops import spmv
    from krylovfspssa_tpu_torch.parallel.sharded import sharded_matvec

    solver = CmeSolver(goutsias_model(), mesh=mesh)
    ops = []

    def keep(inner):
        def operator(table):
            out = inner(table)
            ops[:] = [out]
            return out
        return operator

    mesh.barrier()
    _reset_launches()
    calls = spmv.CALLS
    t0 = time.perf_counter()
    with _spied(solver, "_operator", keep):
        res = solver.solve(TABLE_GOUTSIAS_T, GOUTSIAS[1],
                           fsp_tol=GOUTSIAS[2], krylov_tol=GOUTSIAS[3])
    torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - t0
    calls = spmv.CALLS - calls
    launches = _launches()
    op, vl = ops[0]
    # the timed input: a vector on the last operator's rows (seeded)
    x = vl.put(np.random.default_rng(0).random(op.n.item()))
    mv = sharded_matvec(mesh)
    on_card = all(t.is_cuda for t in op) and x.is_cuda
    mv(op, x)
    mesh.barrier()
    n = 50
    t1 = time.perf_counter()
    for _ in range(n):
        mv(op, x)
    torch.cuda.synchronize(mesh.device)
    mesh.barrier()
    matvec_us = (time.perf_counter() - t1) / n * 1e6
    # its bound: this rank's ELL bytes (as [ell] counts them, over its
    # rows below the global active count op.n) over the card's memory rate
    # plus the all_gather's (P - 1)/P of the global vector (vl.cells
    # entries) over NVLink's rate each way
    rows = op.diag.shape[0]
    act = min(max(int(op.n) - mesh.rank * rows, 0), rows)
    R, item = op.pred_idx.shape[1], x.element_size()
    ell_bytes = act * R * (op.pred_idx.element_size()
                           + op.pred_prop.element_size() + item) \
        + 3 * act * item
    gather_bytes = (mesh.size - 1) / mesh.size * item * vl.cells
    bound_us = (ell_bytes / HBM_BYTES_PER_S
                + gather_bytes / NVLINK_BYTES_PER_S) * 1e6
    return dict(rank=mesh.rank, device=str(mesh.device), wall=wall,
                bound_us=bound_us, ell_bytes=ell_bytes,
                gather_bytes=gather_bytes,
                calls=calls, launches=launches, on_card=on_card,
                rows=rows, capacity=vl.cells,
                matvec_us=matvec_us, dtype=str(solver.dtype),
                stats=(res.stats.iflag, res.stats.nstep, res.stats.nmult,
                       res.stats.n_expansions),
                result=res if mesh.rank == 0 else None)


def phase_sharded_table(one_rank):
    """[sharded-table]: table Goutsias t=30 row-sharded through
    ``CmeSolver(mesh=...)``, against the one-rank solve of [table]
    (L1 <= 2 x fsp_tol); every rank makes at least nmult ELL SpMV calls
    and launches no stencil kernel; the sharded ELL matvec's time per
    call, all_gather included."""
    from krylovfspssa_tpu_torch.parallel.multihost import spawn

    t0 = time.perf_counter()
    devices, backend = _mesh_devices("sharded-table")
    outs = spawn(_sharded_table_rank, devices, backend=backend,
                 timeout_s=600)
    fsp_tol = GOUTSIAS[2]
    for o in outs:
        iflag, nstep, nmult, nexp = o["stats"]
        print(f"[sharded-table] rank {o['rank']} on {o['device']}: nstep "
              f"{nstep} nmult {nmult} expansions {nexp} ELL SpMV calls "
              f"{o['calls']} launches {o['launches']} wall {o['wall']:.2f} "
              f"s; sharded ELL matvec (all_gather included) "
              f"{o['matvec_us']:.1f} us per call on {o['rows']} of "
              f"{o['capacity']} rows; bound {o['bound_us']:.2f} us "
              f"({o['ell_bytes'] / 1e6:.3f} MB of ELL at 3.35 TB/s + "
              f"{o['gather_bytes'] / 1e6:.3f} MB of all_gather at NVLink's "
              f"450 GB/s each way; no single library call)")
        if iflag != 0 or o["dtype"] != "torch.float64" or not o["on_card"]:
            raise AssertionError(f"sharded table rank {o['rank']}: iflag "
                                 f"{iflag}, {o['dtype']}, on card "
                                 f"{o['on_card']}")
        if o["calls"] < nmult or _any_stencil(o["launches"]):
            raise AssertionError(f"rank {o['rank']}: {o['calls']} ELL calls "
                                 f"(nmult {nmult}), launches "
                                 f"{o['launches']}")
        _check_columns(f"[sharded-table] rank {o['rank']}", o["launches"],
                       nmult)
    res = outs[0]["result"]
    l1 = _l1(res, one_rank)
    print(f"[sharded-table] goutsias t={TABLE_GOUTSIAS_T:g}: wsum "
          f"{res.wsum:.10f} fsp {res.stats.final_fsp_size}; one rank: nstep "
          f"{one_rank.stats.nstep} nmult {one_rank.stats.nmult} fsp "
          f"{one_rank.stats.final_fsp_size}; L1 {l1:.3e} (limit "
          f"{2 * fsp_tol:g}); wall {time.perf_counter() - t0:.2f} s with "
          "spawning")
    if not (np.all(np.isfinite(res.probabilities))
            and 1 - fsp_tol <= res.wsum <= 1 + fsp_tol and l1 <= 2 * fsp_tol):
        raise AssertionError(f"sharded table solve: wsum {res.wsum}, L1 "
                             f"{l1:.3e}")
    return dict(matvec_us=[o["matvec_us"] for o in outs],
                bound_us=[o["bound_us"] for o in outs],
                calls=sum(o["calls"] for o in outs))


# ------------------------------------------------------------ table ----

#: the Goutsias flagship's counts in the JAX package's table backend
#: (flagship_r04.json: float64, fsp_tol 1e-6, krylov_tol 1e-8, t=300, the
#: fused loop, chained over resumes: nstep, nmult, nexph and nreject are
#: the whole solve's, n_expansions and n_drops its last call's); printed
#: beside the port's, not asserted (the trajectory forks on the SSA stream
#: and on the dot products' order)
JAX_FLAGSHIP = dict(nstep=126, nmult=15925, nexph=703, nreject=178,
                    n_expansions=12, n_drops=0, fsp_size=1950638,
                    wsum=0.999998996193247)
#: the horizon of the default [table] phase's third Goutsias solve: the
#: first the box cannot reach (2^24 cells > max_box_volume at t=30)
TABLE_GOUTSIAS_T = 30.0
FLAGSHIP_T = 300.0


def _spmv_calls() -> int:
    from krylovfspssa_tpu_torch.ops import spmv

    return spmv.CALLS


@contextlib.contextmanager
def _table_spy(solver):
    """While active, count ``solver``'s fused segments (in
    ``solver.segments``), keep its last operator (``solver.last_op``), and
    check that every operator tensor, w and the active mask a segment gets
    are on the card (the table path must not fall back to the CPU)."""
    solver.segments = 0

    def on_card(what, tensors):
        off = [str(t.device) for t in tensors if not t.is_cuda]
        if off:
            raise AssertionError(f"table path: {what} off the card: {off}")

    def advance_spy(inner):
        def advance(capacity, budget):
            adv = inner(capacity, budget)

            def counted(op, w, active, *args):
                solver.segments += 1
                on_card("operator",
                        op.tensors() if hasattr(op, "tensors") else op)
                on_card("w and active", (w, active))
                return adv(op, w, active, *args)
            return counted
        return advance

    def operator_spy(inner):
        def operator(table):
            out = inner(table)
            solver.last_op = out[0]
            return out
        return operator

    with _spied(solver, "_advance", advance_spy), \
            _spied(solver, "_operator", operator_spy):
        yield


@contextlib.contextmanager
def _table_timers():
    """While active, time each SSA expansion, 1-step round and operator
    build of table solves, the card synchronised before and after each
    (so not under [profile]); yields {"ssa", "onestep", "operator": list
    of seconds}."""
    import torch

    from krylovfspssa_tpu_torch import solver as ts

    times = {"ssa": [], "onestep": [], "operator": []}
    names = {"ssa": "ssa_extend", "onestep": "onestep_extend",
             "operator": "build_operator"}
    saved = {k: getattr(ts, v) for k, v in names.items()}

    def timed(key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[key](*args, **kwargs)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
            return out
        return run

    for k, v in names.items():
        setattr(ts, v, timed(k))
    try:
        yield times
    finally:
        for k, v in names.items():
            setattr(ts, v, saved[k])


def _print_timers(tag, times):
    parts = [f"{k} {1e3 * sum(v) / max(len(v), 1):.1f} ms x{len(v)} "
             f"(total {sum(v):.2f} s)" for k, v in times.items()]
    print(f"[table] {tag}: mean per call: {'; '.join(parts)} (1-step "
          "counts the 5 start-up rounds)")


def _solve_table(model, t, x0, fsp_tol, krylov_tol, config=None):
    """One table-backend solve on the card; returns (solver, result, ELL
    SpMV calls during the solve, wall seconds)."""
    import torch

    from krylovfspssa_tpu_torch import CmeSolver

    solver = CmeSolver(model, config, device="cuda")
    _reset_retakes()
    calls = _spmv_calls()
    t0 = time.perf_counter()
    with _table_spy(solver):
        res = solver.solve(t, x0, fsp_tol=fsp_tol, krylov_tol=krylov_tol)
    torch.cuda.synchronize()
    return solver, res, _spmv_calls() - calls, time.perf_counter() - t0


def _check_table(tag, solver, res, calls, fsp_tol):
    """The gate of PERF.md §2 for a table solve: float64, iflag 0, finite
    probabilities, wsum within fsp_tol, every matvec an ELL SpMV (``calls``
    counts this run's)."""
    import torch

    s = res.stats
    if solver.dtype != torch.float64:
        raise AssertionError(f"{tag}: solve ran in {solver.dtype}")
    if s.iflag != 0 or not np.all(np.isfinite(res.probabilities)):
        raise AssertionError(f"{tag}: iflag {s.iflag} or non-finite values")
    if not 1 - fsp_tol <= res.wsum <= 1 + fsp_tol:
        raise AssertionError(f"{tag}: wsum {res.wsum} outside 1 +- "
                             f"{fsp_tol:g}")
    if calls < s.nmult:
        raise AssertionError(f"{tag}: {calls} ELL SpMV calls < the "
                             f"{s.nmult} matvecs of this run")


def _print_table(tag, solver, res, calls, wall, peak_gib):
    s = res.stats
    print(f"[table] {tag} (fused, {solver.segments} segments) nstep "
          f"{s.nstep} nmult {s.nmult} nreject {s.nreject} nexph {s.nexph} "
          f"expansions {s.n_expansions} drops {s.n_drops} fsp "
          f"{s.final_fsp_size} capacity {res.table.capacity} m_eff "
          f"{solver._m_eff(res.table.capacity)} key words "
          f"{res.table.encoder.n_words} wsum {res.wsum!r} retakes "
          f"{_retakes()} ELL SpMV calls {calls} wall {wall:.2f} s peak "
          f"device memory {peak_gib:.2f} GiB")


def _table_solve(tag, model, scenario, box_result=None):
    """A gated table solve of ``scenario`` (t, x0, fsp_tol, krylov_tol);
    with ``box_result``, within 2 x fsp_tol of that box solve (L1 over the
    union of supports).  Returns (solver, result, SpMV calls)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    before = _launches()
    with _table_timers() as times:
        solver, res, calls, wall = _solve_table(model, *scenario)
    launches = {k: v - before[k] for k, v in _launches().items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _print_table(tag, solver, res, calls, wall, peak)
    _print_timers(tag, times)
    fsp_tol = scenario[2]
    _check_table(tag, solver, res, calls, fsp_tol)
    _check_columns(f"[table] {tag}", launches, res.stats.nmult)
    if box_result is not None:
        l1 = _l1(res, box_result)
        print(f"[table] {tag}: L1 to the box solve {l1:.3e} (limit "
              f"{2 * fsp_tol:g}; box fsp {box_result.stats.final_fsp_size} "
              f"in {box_result.box.volume} cells, table fsp "
              f"{res.stats.final_fsp_size})")
        if not l1 <= 2 * fsp_tol:
            raise AssertionError(f"{tag}: table and box solves differ: L1 "
                                 f"{l1:.3e}")
    return solver, res, calls


def phase_table(toggle_box, goutsias_box):
    """[table]: the table backend (``solve_cme`` on the card, the fused
    loop): toggle t=1000 and Goutsias t=10, each held against the box
    solve of the same scenario, and Goutsias t=30, which the box cannot
    reach.  Returns (the last solve's operator, its final w as a
    capacity-sized vector on the card, its state count)."""
    import torch

    from krylovfspssa_tpu_torch import native
    from krylovfspssa_tpu_torch.models.library import (
        goutsias_model,
        toggle_file_model,
    )

    t0 = time.perf_counter()
    info = native.build()
    print(f"[table] native hash built in {info.seconds:.2f} s -> "
          f"{info.path}")
    _table_solve("toggle t=1000", toggle_file_model(), TOGGLE, toggle_box)
    _table_solve("goutsias t=10", goutsias_model(), GOUTSIAS, goutsias_box)
    solver, res, _ = _table_solve(
        f"goutsias t={TABLE_GOUTSIAS_T:g}", goutsias_model(),
        (TABLE_GOUTSIAS_T, *GOUTSIAS[1:]))
    print(f"[table] goutsias t={TABLE_GOUTSIAS_T:g}: "
          f"{res.stats.final_fsp_size} states (the box would need 2^24 "
          f"cells > max_box_volume 2^23); phase wall "
          f"{time.perf_counter() - t0:.2f} s")
    op = solver.last_op
    x = torch.zeros(op.diag.shape[0], dtype=torch.float64, device="cuda")
    x[: res.table.n] = torch.as_tensor(res.probabilities, device="cuda")
    return op, x, res.table.n, res


def _pencil_bound(op, n_states):
    """pencil_matvec's bound from what its operands need: per cell the
    mask byte, D, R pred fields, x and y; the two source-row tables; per
    member state -D*x and a multiply-add per reaction."""
    item = op.diag.element_size()
    cells = op.diag.shape[0]
    R = op.pred_prop.shape[0]
    nbytes = cells * (1 + item * (R + 3)) + _nbytes(op.src_a, op.src_b)
    return _bound(nbytes, n_states * (2 * R + 2), op.diag.dtype)


def _pencil_vs_ell(tag, solver, table, calls):
    """pencil_matvec against the ELL spmv on one state set (``table``): the
    same y at every state (1e-12 of the largest |D x|), their times, the
    pencil's bound and a CSR SpMV of the same generator."""
    import torch

    from krylovfspssa_tpu_torch.ops.operator import build_operator
    from krylovfspssa_tpu_torch.ops.pencil import pencil_matvec
    from krylovfspssa_tpu_torch.ops.spmv import spmv

    dev = torch.device("cuda")
    pop, pvl = solver._pencil_operator(table)
    eop = build_operator(
        torch.as_tensor(table.states, device=dev),
        torch.as_tensor(table.sorted_keys, device=dev),
        torch.as_tensor(table.sorted_to_row, device=dev), table.n,
        solver._props_fn, solver._stoich, solver.encoder, torch.float64)
    n = table.n
    w = np.random.default_rng(1).random(n)
    xp = pvl.put(w)
    xe = torch.zeros(table.capacity, dtype=torch.float64, device=dev)
    xe[:n] = torch.as_tensor(w, device=dev)
    slots = torch.as_tensor(pvl.layout.slot_of_state, device=dev)
    yp = pencil_matvec(pop, xp)[slots]
    ye = spmv(eop, xe)[:n]
    scale = float(torch.max(torch.abs(eop.diag * xe)))
    err = float(torch.max(torch.abs(yp - ye)))
    ms_p = _time_ms(pencil_matvec, pop, xp)
    ms_e = _time_ms(spmv, eop, xe)
    bound = _pencil_bound(pop, n)
    i = torch.arange(n, device=dev)
    R = eop.pred_idx.shape[1]
    pi = eop.pred_idx[:n].long()
    keep = pi >= 0
    matrix = _csr([i, i.repeat_interleave(R)[keep.reshape(-1)]],
                  [i, pi[keep]], [-eop.diag[:n], eop.pred_prop[:n][keep]],
                  (table.capacity, table.capacity))
    library_ms = _library(matrix, xe, spmv(eop, xe), F64_RTOL, scale)
    cells = pop.diag.shape[0]
    print(f"[pencil] {tag}: {n} states in {pvl.layout.n_cells} pencil cells "
          f"({pvl.layout.n_cells / n:.2f}x; {cells} with the rows bucket), "
          f"lane species {pvl.layout.lane_species}; max_abs_err vs ELL "
          f"{err:.3e} (limit {F64_RTOL:g} x {scale:.3e}); pencil_matvec "
          f"{ms_p * 1e3:.1f} us, ELL spmv {ms_e * 1e3:.1f} us, pencil bound "
          f"{bound[0] * 1e3:.1f} us ({bound[1]}; "
          f"{100 * bound[0] / ms_p:.0f}% of it), CSR library "
          f"{library_ms * 1e3:.1f} us; pencil calls {calls}")
    if not err <= F64_RTOL * scale:
        raise AssertionError(f"{tag}: pencil and ELL matvecs differ: "
                             f"{err:.3e}")
    return dict(ms=ms_p, ell_ms=ms_e, bound_ms=bound[0], bound_by=bound[1],
                library_ms=library_ms, max_abs_err=err, calls=calls,
                cells=cells, states=n)


def phase_pencil(ell_res):
    """[pencil]: table Goutsias t=30 with table_operator="pencil" (the
    JAX package's TPU operator; opt-in here) against the ELL solve of
    [table] within 2 x fsp_tol, every matvec a pencil_matvec; then the
    pencil matvec against the ELL spmv on its final state set."""
    from krylovfspssa_tpu_torch import SolverConfig
    from krylovfspssa_tpu_torch.models.library import goutsias_model
    from krylovfspssa_tpu_torch.ops import pencil

    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    calls = pencil.CALLS
    solver, res, spmv_calls, wall = _solve_table(
        goutsias_model(), TABLE_GOUTSIAS_T, *GOUTSIAS[1:],
        config=SolverConfig(table_operator="pencil"))
    calls = pencil.CALLS - calls
    _print_table(f"pencil goutsias t={TABLE_GOUTSIAS_T:g}", solver, res,
                 spmv_calls, wall, torch.cuda.max_memory_allocated() / 2 ** 30)
    fsp_tol = GOUTSIAS[2]
    _check_table("pencil", solver, res, calls, fsp_tol)
    if type(solver.last_op).__name__ != "PencilOperator":
        raise AssertionError(f"pencil solve built {type(solver.last_op)}")
    l1 = _l1(res, ell_res)
    print(f"[pencil] L1 to the ELL solve {l1:.3e} (limit {2 * fsp_tol:g}); "
          f"pencil_matvec calls {calls} (nmult {res.stats.nmult})")
    if not l1 <= 2 * fsp_tol:
        raise AssertionError(f"pencil solve differs from ELL: L1 {l1:.3e}")
    row = _pencil_vs_ell(f"goutsias t={TABLE_GOUTSIAS_T:g} final states",
                         solver, res.table, calls)
    print(f"[pencil] wall {time.perf_counter() - t0:.2f} s")
    return row


def phase_ell(op, x, n, calls):
    """[ell]: the table path's gather-ELL SpMV (torch ops; the JAX package
    computes it outside any Pallas kernel) on a solve's last operator and
    final w: its time beside its bound (pred_idx, pred_prop and the
    gathered x per entry, diag, x and y per row, rows up to n, at their own
    item sizes, over 3.35 TB/s) and one CSR SpMV of the same operator."""
    import torch

    from krylovfspssa_tpu_torch.ops.spmv import spmv

    R = op.pred_idx.shape[1]
    y = spmv(op, x)
    item = x.element_size()
    nbytes = n * R * (op.pred_idx.element_size() + op.pred_prop.element_size()
                      + item) + 3 * n * item
    bound = _bound(nbytes, n * (2 * R + 2), x.dtype)
    i = torch.arange(n, device="cuda")
    pi = op.pred_idx[:n].long()
    keep = pi >= 0
    rows = [i, i.repeat_interleave(R)[keep.reshape(-1)]]
    cols = [i, pi[keep]]
    vals = [-op.diag[:n], op.pred_prop[:n][keep]]
    cap = op.diag.shape[0]
    matrix = _csr(rows, cols, vals, (cap, cap))
    scale = float(torch.max(torch.abs(op.diag * x)))
    library_ms = _library(matrix, x, y, F64_RTOL, scale)
    ms = _time_ms(spmv, op, x)
    print(f"[ell] ELL SpMV on the last operator ({n} rows of {cap}, R={R}, "
          f"{str(x.dtype)[6:]}): {ms * 1e3:.1f} us per matvec, bound "
          f"{bound[0] * 1e3:.1f} us ({bound[1]}; {nbytes / 1e6:.1f} MB; "
          f"{100 * bound[0] / ms:.0f}% of it), CSR library "
          f"{library_ms * 1e3:.1f} us; SpMV calls on the table path {calls}")
    return dict(ms=ms, bound_ms=bound[0], bound_by=bound[1],
                library_ms=library_ms, calls=calls)


BENCH_SCALE = 64
BENCH_ITERS = 400


def phase_bench() -> dict:
    """[bench]: ``kfs-torch bench --scale 64`` (4,194,304 cells) in a
    subprocess on the card: it must exit 0 with one JSON line of value > 0,
    and each variant must have launched its kernel at least once per
    chained matvec.  Returns {variant: (us per matvec, launches)}."""
    import re

    t0 = time.perf_counter()
    # the load guard is off: this run's own earlier phases raise the
    # host's 1-minute load average
    out = subprocess.run(
        [sys.executable, "-m", "krylovfspssa_tpu_torch.cli", "bench",
         "--scale", str(BENCH_SCALE), "--ignore-load"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    for line in out.stderr.splitlines():
        print(f"[bench]   {line}")
    lines = out.stdout.strip().splitlines()
    for line in lines:
        print(f"[bench] {line}")
    if out.returncode != 0:
        raise AssertionError(f"kfs-torch bench exited {out.returncode}")
    if len(lines) != 1 or not json.loads(lines[0])["value"] > 0:
        raise AssertionError(f"kfs-torch bench printed {lines}")
    rows = {}
    for m in re.finditer(r"^(\S+): (\S+) us/matvec .* launches (\d+)$",
                         out.stderr, re.M):
        rows[m.group(1)] = (float(m.group(2)), int(m.group(3)))
    names = [f"{k}-{d}" for k in ("box_stencil", "direct_stencil")
             for d in ("f64", "f32")]
    for name in names:
        if name not in rows or rows[name][1] < BENCH_ITERS:
            raise AssertionError(f"[bench] {name}: {rows.get(name)} (at "
                                 f"least {BENCH_ITERS} launches)")
    print(f"[bench] wall {time.perf_counter() - t0:.1f} s")
    return rows


def table_flagship(smi) -> int:
    """``--table-flagship``: Goutsias t=300 (reference
    examples/transcr6d.f90) on the table backend at the reference
    tolerances, in float64, in the default fused loop.  Gate: iflag 0 and
    wsum >= 1 - 1e-6; the counts and the peak device memory are printed
    beside the JAX package's (flagship_r04.json)."""
    import torch

    from krylovfspssa_tpu_torch import CmeSolver, SolverConfig
    from krylovfspssa_tpu_torch.models.library import goutsias_model

    t0 = time.perf_counter()
    solver = CmeSolver(goutsias_model(), SolverConfig(dtype="float64",
                                                      verbosity=2),
                       device="cuda")
    torch.cuda.reset_peak_memory_stats()
    calls = _spmv_calls()
    with _table_spy(solver), _table_timers() as times:
        res = solver.solve(FLAGSHIP_T, GOUTSIAS[1], fsp_tol=GOUTSIAS[2],
                           krylov_tol=GOUTSIAS[3])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = _spmv_calls() - calls
    s = res.stats
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    port = dict(nstep=s.nstep, nmult=s.nmult, nexph=s.nexph,
                nreject=s.nreject, n_expansions=s.n_expansions,
                n_drops=s.n_drops, fsp_size=s.final_fsp_size, wsum=res.wsum)
    print(f"[flagship] goutsias t={FLAGSHIP_T:g}, {s.nstep} steps "
          f"(fused, {solver.segments} segments), wall {wall:.1f} s, "
          f"peak device memory {peak:.2f} GiB, ELL SpMV calls {calls}")
    for k, v in port.items():
        print(f"[flagship]   {k:13s} port {v}   JAX package "
              f"(flagship_r04.json) {JAX_FLAGSHIP[k]}")
    _print_timers("flagship", times)
    _check_table("flagship", solver, res, calls, GOUTSIAS[2])
    op = solver.last_op
    x = torch.zeros(op.diag.shape[0], dtype=torch.float64, device="cuda")
    x[: res.table.n] = torch.as_tensor(res.probabilities, device="cuda")
    ell = phase_ell(op, x, res.table.n, calls)
    del op, x
    solver._pencil_lane = int(np.argmax(
        res.table.states[: res.table.n].max(axis=0)))
    pencil_row = _pencil_vs_ell(f"flagship t={FLAGSHIP_T:g} final states",
                                solver, res.table, 0)
    ell["pencil"] = pencil_row
    if res.wsum > 1 + 1e-12:
        raise AssertionError(f"flagship wsum {res.wsum} > 1")
    print(f"[flagship] wsum {res.wsum:.10f} >= 1 - 1e-6, iflag 0: ok")
    print(json.dumps({"flagship": dict(port, wall_s=wall, peak_gib=peak,
                                       ell=ell, device=smi)}))
    return 0


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
    """``--sharded-only``: the row-sharded paths and what they are held
    against, alone (for a machine with several cards): the one-rank
    Goutsias solve of phase 3, after a t=1 warm-up solve so that its wall
    compares with the ranks' warm ones, then [sharded] (with
    [sharded-gather]); the one-card library ge5d, then [sharded-direct];
    the one-rank table Goutsias t=30, then [sharded-table]."""
    from krylovfspssa_tpu_torch.models.library import (
        ge5d_model,
        goutsias_model,
    )

    t_start = time.perf_counter()
    _solve(goutsias_model(), 1.0, *GOUTSIAS[1:])
    _reset_launches()
    one = phase_goutsias()
    phase_sharded(one)
    solver, ge5d_one, launches, wall = _solve(ge5d_model(), *_ge5d_args())
    _print_solve("ge5d-library", solver, ge5d_one, launches, wall)
    _check_solve("ge5d-library", solver, ge5d_one, launches, 1 - 1e-4,
                 1 + 1e-4, kernel="direct_stencil")
    del solver
    phase_sharded_direct(ge5d_one)
    _, table_one, _ = _table_solve(f"goutsias t={TABLE_GOUTSIAS_T:g}",
                                   goutsias_model(),
                                   (TABLE_GOUTSIAS_T, *GOUTSIAS[1:]))
    phase_sharded_table(table_one)
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
                    help="run only the sharded paths ([sharded], "
                    "[sharded-direct], [sharded-table]) and the one-rank "
                    "solves they are held against (one NCCL rank per "
                    "visible card, up to 4)")
    ap.add_argument("--table-flagship", action="store_true",
                    help="run only the Goutsias t=300 flagship on the table "
                    "backend")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    torch.cuda.set_device(0)
    smi = phase_env()
    if args.sharded_only:
        return sharded_only(smi)
    if args.table_flagship:
        return table_flagship(smi)
    t_start = time.perf_counter()
    phase_small_solve()

    # path 1, separable models: every launch is a solve's box_stencil matvec
    def separable():
        return phase_toggle(), phase_goutsias()

    sep, (toggle_one, goutsias_one) = _path_launches(
        "separable path", separable,
        ["box_stencil", "expm_pade", "arnoldi_column"])
    if sep["direct_stencil"] or sep["halo_stencil"]:
        raise AssertionError(f"separable models launched another kernel: "
                             f"{sep}")

    # path 2, custom propensities: direct_stencil (and box_stencil for the
    # .input ge5d that the library's ge5d is held against)
    def custom():
        return phase_customprop(), phase_ge5d()

    cus, (customprop, (ge5d, ge5d_box, ge5d_input, ge5d_one)) = (
        _path_launches("custom path", custom,
                       ["direct_stencil", "box_stencil", "expm_pade",
                        "arnoldi_column"]))
    # path 3, the row-sharded solve: halo_stencil in every rank (and the
    # same solve with use_halo=False, counted in its own window)
    shl, gathered = phase_sharded(goutsias_one)
    # path 3b, the row-sharded solve of a model that does not factor:
    # direct_stencil on a row shard in every rank
    sdl = phase_sharded_direct(ge5d_one)
    # path 4, the table backend: no stencil kernel; every matvec is the
    # gather-ELL SpMV (torch ops), counted apart from the kernels
    calls = _spmv_calls()
    tab, (ell_op, ell_x, ell_n, table_one) = _path_launches(
        "table path", lambda: phase_table(toggle_one, goutsias_one),
        ["expm_pade", "arnoldi_column"])
    table_calls = _spmv_calls() - calls
    if _any_stencil(tab):
        raise AssertionError(f"table path launched a stencil kernel: {tab}")
    # path 4b, the row-sharded table (each rank checks that it launched no
    # stencil kernel), and 4c, the pencil operator (torch ops, no kernel)
    phase_sharded_table(table_one)
    pen_tab, pencil_row = _path_launches(
        "pencil path", lambda: phase_pencil(table_one),
        ["expm_pade", "arnoldi_column"])
    if _any_stencil(pen_tab):
        raise AssertionError(f"pencil path launched a stencil kernel: "
                             f"{pen_tab}")
    # off the counted paths: the other loop, a non-default budget, profiles
    phase_fused(toggle_one)
    phase_profiles()
    step = phase_step(toggle_one, goutsias_one)

    launches = {k: sep[k] + cus[k] + shl[k] + gathered[k] + sdl[k]
                for k in sep}
    # expm_pade runs in every solve, the table paths' too
    step["launches"] = (launches["expm_pade"] + tab["expm_pade"]
                        + pen_tab["expm_pade"])
    print(f"[paths] launches of the solve paths: {launches}")
    box = phase_kernels(launches["box_stencil"], {
        "toggle": (toggle_file_model(), toggle_one),
        "goutsias": (goutsias_model(), goutsias_one)})
    direct = phase_direct_kernels(
        launches["direct_stencil"], ge5d, ge5d_box,
        {"customprop": customprop, "ge5d": (ge5d, ge5d_box, ge5d_input)})
    direct_shards = phase_direct_halo(ge5d, ge5d_box,
                                      launches["direct_stencil"])
    direct["shards"] = {str(p): {k: row[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms",
        "shard_ms", "shard_bound_ms", "shard_library_ms")}
        for p, row in direct_shards.items()}
    halo = phase_halo(goutsias_one.box, launches["halo_stencil"])
    # every solve path's columns, the table paths' too
    columns = phase_arnoldi(
        launches["arnoldi_column"] + tab["arnoldi_column"]
        + pen_tab["arnoldi_column"], {
            "toggle": (toggle_file_model(), toggle_one),
            "goutsias": (goutsias_model(), goutsias_one)})
    phase_ell(ell_op, ell_x, ell_n, table_calls)
    del ell_op, ell_x
    bench = phase_bench()
    for row, kernel in ((box, "box_stencil"), (direct, "direct_stencil")):
        row["bench"] = {d: {"us_per_matvec": bench[f"{kernel}-{d}"][0],
                            "launches": bench[f"{kernel}-{d}"][1]}
                        for d in ("f64", "f32")}
    print(f"[pencil] summary: {json.dumps(pencil_row)}")

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
    }, **halo), dict({
        "name": "expm_pade",
        "route": "cuda",
        "source": "krylovfspssa_tpu_torch/csrc/expm_pade.cu",
        # the JAX package's XLA expm: not a Pallas kernel
        "replaces": "krylovfspssa_tpu/ops/expm.py:79",
    }, **step), dict({
        "name": "arnoldi_column",
        "route": "cuda",
        "source": "krylovfspssa_tpu_torch/csrc/arnoldi_column.cu",
        # the JAX package's column is XLA ops: not a Pallas kernel
        "replaces": "krylovfspssa_tpu/krylov/arnoldi.py:77",
    }, **columns)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
