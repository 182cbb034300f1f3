#!/usr/bin/env python3
"""The toggle t=1000 solve under the ``expm_pade`` kernel of this checkout,
under its plain version and, with ``--old``, under another kernel source,
on one NVIDIA GPU.

    python3 ab_expm.py [--old PATH] [--trace]

``--old PATH`` names a ``.cu`` file with the same C entry point
(``kfs_expm_pade``), built with nvcc into ``build/ab_expm/``; an earlier
commit's kernel, for example::

    mkdir -p build/ab_expm
    git show 8d164a8:krylovfspssa_tpu_torch/csrc/expm_pade.cu \\
        > build/ab_expm/pr9.cu
    python3 ab_expm.py --old build/ab_expm/pr9.cu

Each kernel is first held against the plain version on random Hessenbergs
(mx 12 to 102: the max relative error).  Then each exponential drives the
reference's TestSolverFromFile toggle (t=1000, fsp_tol 1e-4, krylov_tol
1e-10, the default fused loop) through ``solve_cme_box``; every call is
bracketed by CUDA events, read after the solve.  Each run prints one line:
wsum, iflag, steps, matvecs, exponentials, wall, the summed expm
milliseconds and the breakdown steps the stepper took again
(``stepper.RETAKES``, by cause), or the error that ended it.  The trajectory forks on the
exponential's round-off, so steps and wall differ between equally accurate
arithmetics; the summed expm time is the kernel's share of the wall.  With
``--old``, that run's exponentials (its fork's inputs) are then replayed
through every kernel and the plain version: the summed milliseconds on
one and the same set of calls.

``--trace`` also prints every attempted step that is longer than 2 time
units, asks for an expansion, does not advance or was taken again: its
start, length, mass, the cause of a retake, and the values of each of its
device reads (an attempt's read starts with the breakdown flag and the
broken column; an FSP evaluation's with the mass; a retaken step shows
both attempts' reads).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def _old_kernel(path: Path):
    """expm_pade(H, mx, t, ideg) through the kfs_expm_pade of the source
    at ``path`` (its own library), with a scratch of 4 (MH + 16)^2
    doubles: enough for this checkout's four padded matrices and for an
    earlier kernel's 3 MH^2."""
    import torch

    from krylovfspssa_tpu_torch.ops import expm, stencil_cuda

    out = ROOT / "build" / "ab_expm"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{path.stem}.so"
    subprocess.run([stencil_cuda._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(so),
                    str(path)], check=True)
    fn = ctypes.CDLL(str(so)).kfs_expm_pade
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def expm_old(H, mx, t, ideg=6):
        dev, MH = H.device, H.shape[0]
        mx = expm._on_device(mx, torch.int64, dev)
        t = expm._on_device(t, torch.float64, dev)
        E = torch.empty_like(H)
        stats = torch.empty(2, dtype=torch.float64, device=dev)
        scratch = torch.empty(4 * (MH + 16) ** 2, dtype=torch.float64,
                              device=dev)
        stencil_cuda._launch("expm_pade (--old)", fn, dev, (
            H.data_ptr(), mx.data_ptr(), t.data_ptr(), E.data_ptr(),
            stats.data_ptr(), scratch.data_ptr(), MH, ideg))
        return E, stats[0], stats[1]

    return expm_old


def _accuracy(expm_fn) -> float:
    """Max over random Hessenbergs (mx 12 to 102) of max|E - E_plain| /
    max|E_plain|."""
    import torch

    from krylovfspssa_tpu_torch.ops import expm

    rng = np.random.default_rng(0)
    worst = 0.0
    for mx, t, scale in ((12, 0.7, 1.0), (32, 2.5, 40.0), (64, 1.0, 5.0),
                         (102, 0.2, 2.0)):
        H = rng.normal(size=(102, 102))
        H[:mx, :mx] = np.triu(rng.random((mx, mx)), -1) * scale
        H[np.arange(mx), np.arange(mx)] = -scale * (1 + rng.random(mx))
        Ht = torch.as_tensor(H, device="cuda")
        Ek = expm_fn(Ht, mx, t)[0]
        Ep = expm.expm_pade_plain(Ht, mx, t)[0]
        worst = max(worst, float((Ek - Ep).abs().max() / Ep.abs().max()))
    return worst


def _toggle(stepper, expm_fn, keep=False):
    """The toggle t=1000 solve with ``expm_fn`` as the stepper's
    exponential, each call bracketed by CUDA events (chip_smoke's
    ``expm_spy``): its line, and the calls' (Hbar, mx, t, ideg) if
    ``keep``."""
    import torch

    from chip_smoke import expm_spy
    from krylovfspssa_tpu_torch import solve_cme_box
    from krylovfspssa_tpu_torch.models.library import toggle_file_model

    inner, stepper.expm_pade = stepper.expm_pade, expm_fn
    for k in stepper.RETAKES:
        stepper.RETAKES[k] = 0
    t0 = time.perf_counter()
    try:
        with expm_spy(keep) as calls:
            r = solve_cme_box(toggle_file_model(), 1000.0, [[0, 0]],
                              fsp_tol=1e-4, krylov_tol=1e-10)
            torch.cuda.synchronize()
    except Exception as e:  # the outcome of this run, not a failure
        return (f"{type(e).__name__}: {e} after "
                f"{time.perf_counter() - t0:.2f} s"), []
    finally:
        stepper.expm_pade = inner
    wall = time.perf_counter() - t0
    ms = sum(a.elapsed_time(b) for a, b, _, _ in calls)
    s = r.stats
    return (f"wsum {r.wsum!r} iflag {s.iflag} nstep {s.nstep} nmult "
            f"{s.nmult} nexph {s.nexph} box {r.box.shape} wall {wall:.2f} s "
            f"summed expm {ms:.1f} ms over {len(calls)} calls retakes "
            f"{dict(stepper.RETAKES)}"), \
        [inputs for *_, inputs in calls if inputs is not None]


def _replay(calls, expm_fn) -> float:
    """Summed milliseconds of ``expm_fn`` over the kept calls (a warm-up
    pass first; events around each call)."""
    import torch

    for H, mx, t, ideg in calls[:8]:
        expm_fn(H, mx, t, ideg)
    events = []
    for H, mx, t, ideg in calls:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        expm_fn(H, mx, t, ideg)
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events)


def _trace(stepper, advance, boxsolver) -> None:
    """Wrap every step function the solver builds to print the attempted
    steps that --trace selects, with the values of their device reads."""
    reads = []
    inner_read, inner_make = stepper.read, stepper.make_step_fn

    def read(t):
        vals = inner_read(t)
        reads.append(vals)
        return vals

    def make_step_fn(*args, **kwargs):
        step = inner_make(*args, **kwargs)

        def traced(op, w, sc, t_out, fsptol, krytol):
            reads.clear()
            before = dict(stepper.RETAKES)
            r = step(op, w, sc, t_out, fsptol, krytol)
            retake = [k for k, v in stepper.RETAKES.items()
                      if v != before[k]]
            if r.t_step > 2.0 or r.iexpand or not r.advanced or retake:
                vals = " | ".join(",".join(f"{x:.10g}" for x in v)
                                  for v in reads)
                print(f"[ab_expm]   t={float(sc.t_now):.6g} step "
                      f"{r.t_step:.6g} wsum {r.wsum!r} advanced "
                      f"{r.advanced} expand {r.iexpand} (SSA horizon "
                      f"{r.t_ssa:.4g}) cells {w.numel()} retake "
                      f"{','.join(retake) or '-'}; reads {vals}")
            return r

        return traced

    stepper.read = read
    stepper.make_step_fn = make_step_fn
    advance.make_step_fn = boxsolver.make_step_fn = make_step_fn


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path,
                    help="another expm_pade.cu to drive the solve with")
    ap.add_argument("--trace", action="store_true",
                    help="print the long, expanding and rejected steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_expm: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from krylovfspssa_tpu_torch import boxsolver
    from krylovfspssa_tpu_torch.krylov import advance, stepper
    from krylovfspssa_tpu_torch.ops import expm

    if args.trace:
        _trace(stepper, advance, boxsolver)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[ab_expm] {smi}; torch {torch.__version__}")
    runs = [("kernel (csrc/expm_pade.cu)", expm.expm_pade)]
    if args.old is not None:
        runs.append((f"--old {args.old}", _old_kernel(args.old)))
    runs.append(("plain version", expm.expm_pade_plain))
    kept = []
    for name, fn in runs:
        acc = ("" if fn is expm.expm_pade_plain else
               f"max rel err vs plain {_accuracy(fn):.2e}; ")
        line, inputs = _toggle(stepper, fn, keep=name.startswith("--old"))
        kept += inputs
        print(f"[ab_expm] {name}: {acc}toggle t=1000: {line}", flush=True)
    if kept:
        # the same exponentials (the --old run's fork) through each
        times = ", ".join(f"{name} {_replay(kept, fn):.1f} ms"
                          for name, fn in runs)
        print(f"[ab_expm] the --old run's {len(kept)} exponentials "
              f"replayed: {times}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
