#!/usr/bin/env python3
"""The toggle t=1000 solve under four float64 arithmetics of the
``expm_pade`` kernel and under its plain version, on one NVIDIA GPU.

    python3 ab_expm.py [--trace]

Builds four variants of ``krylovfspssa_tpu_torch/csrc/expm_pade.cu`` (one
nvcc each, in parallel, into ``build/ab_expm/``): the shipped one (every
product rounded before it is added; back substitution by columns), with
fused multiply-adds, with the back substitution by rows as the JAX
package's ``solve_plu`` writes it, and with both.  Each variant is held
against the plain version on random Hessenbergs (max relative error), then
drives the reference's TestSolverFromFile toggle (t=1000, fsp_tol 1e-4,
krylov_tol 1e-10, the default fused loop) through ``solve_cme_box``; the
plain version (cuBLAS products, cuSOLVER LU) drives it last.  Each line
gives the solve's outcome: wsum, iflag, steps, matvecs, final box and its
largest step, or the error that ended it.  The variants are equally
accurate and the trajectory forks on their round-off, so the lines show
whether the solve's outcome depends on which fork it takes (ROADMAP.md
Queue C, the breakdown-step overflow).

``--trace`` also prints every attempted step that is longer than 2 time
units, asks for an expansion or does not advance: its start, length,
mass, and the values of each of its device reads (an attempt's read
starts with the breakdown flag and the broken column; an FSP evaluation's
with the mass).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "krylovfspssa_tpu_torch" / "csrc" / "expm_pade.cu"

ROUNDED = ("  return __dadd_rn(acc, __dmul_rn(a, b));",
           "  return __dsub_rn(acc, __dmul_rn(a, b));")
FUSED = ("  return acc + a * b;", "  return acc - a * b;")
COLUMNS = """  for (int k = n - 1; k >= 0; --k) {
    const double d = Q(k, k);
    for (int j = threadIdx.x; j < n; j += blockDim.x) P(k, j) /= d;
    __syncthreads();
    for (int e = threadIdx.x; e < k * n; e += blockDim.x) {
      const int i = e / n, j = e % n;
      P(i, j) = msub(P(i, j), Q(i, k), P(k, j));
    }
    __syncthreads();
  }"""
ROWS = """  for (int k = n - 1; k >= 0; --k) {
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      double acc = 0.0;
      for (int j = k + 1; j < n; ++j) acc = madd(acc, Q(k, j), P(j, c));
      P(k, c) = (P(k, c) - acc) / Q(k, k);
    }
    __syncthreads();
  }"""


def _variant(fma: bool, rows: bool) -> str:
    src = SRC.read_text()
    for old, new in zip(ROUNDED, FUSED) if fma else ():
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    if rows:
        assert src.count(COLUMNS) == 1
        src = src.replace(COLUMNS, ROWS)
    return src


VARIANTS = {
    "shipped (rounded products, column back substitution)": (False, False),
    "fused multiply-add": (True, False),
    "row back substitution (JAX solve_plu)": (False, True),
    "fused multiply-add, row back substitution": (True, True),
}


def _build(args):
    i, (fma, rows) = args
    out = ROOT / "build" / "ab_expm"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"v{i}.cu", out / f"v{i}.so"
    cu.write_text(_variant(fma, rows))
    from krylovfspssa_tpu_torch.ops.stencil_cuda import _nvcc

    subprocess.run([_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)],
                   check=True)
    return so


def _accuracy(expm) -> float:
    """Max over random Hessenbergs (mx 12 to 102) of max|E - E_plain| /
    max|E_plain|."""
    import torch

    rng = np.random.default_rng(0)
    worst = 0.0
    for mx, t, scale in ((12, 0.7, 1.0), (32, 2.5, 40.0), (64, 1.0, 5.0),
                         (102, 0.2, 2.0)):
        H = rng.normal(size=(102, 102))
        H[:mx, :mx] = np.triu(rng.random((mx, mx)), -1) * scale
        H[np.arange(mx), np.arange(mx)] = -scale * (1 + rng.random(mx))
        Ht = torch.as_tensor(H, device="cuda")
        Ek = expm.expm_pade(Ht, mx, t)[0]
        Ep = expm.expm_pade_plain(Ht, mx, t)[0]
        worst = max(worst, float((Ek - Ep).abs().max() / Ep.abs().max()))
    return worst


def _toggle() -> str:
    import torch

    from krylovfspssa_tpu_torch import solve_cme_box
    from krylovfspssa_tpu_torch.models.library import toggle_file_model

    t0 = time.perf_counter()
    try:
        r = solve_cme_box(toggle_file_model(), 1000.0, [[0, 0]],
                          fsp_tol=1e-4, krylov_tol=1e-10)
        torch.cuda.synchronize()
    except Exception as e:  # the outcome of this variant, not a failure
        return f"{type(e).__name__}: {e} after {time.perf_counter() - t0:.2f} s"
    big = max(rec.t_step for rec in r.stats.records)
    return (f"wsum {r.wsum!r} iflag {r.stats.iflag} nstep {r.stats.nstep} "
            f"nmult {r.stats.nmult} box {r.box.shape} largest step {big!r} "
            f"wall {time.perf_counter() - t0:.2f} s")


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
            r = step(op, w, sc, t_out, fsptol, krytol)
            if r.t_step > 2.0 or r.iexpand or not r.advanced:
                vals = " | ".join(",".join(f"{x:.10g}" for x in v)
                                  for v in reads)
                print(f"[ab_expm]   t={float(sc.t_now):.6g} step "
                      f"{r.t_step:.6g} wsum {r.wsum!r} advanced "
                      f"{r.advanced} expand {r.iexpand} (SSA horizon "
                      f"{r.t_ssa:.4g}) cells {w.numel()}; reads {vals}")
            return r

        return traced

    stepper.read = read
    stepper.make_step_fn = make_step_fn
    advance.make_step_fn = boxsolver.make_step_fn = make_step_fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_expm: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from krylovfspssa_tpu_torch import boxsolver
    from krylovfspssa_tpu_torch.krylov import advance, stepper
    from krylovfspssa_tpu_torch.ops import expm, stencil_cuda

    if "--trace" in sys.argv[1:]:
        _trace(stepper, advance, boxsolver)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[ab_expm] {smi}; torch {torch.__version__}")
    lib = stencil_cuda._library()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = list(ex.map(_build, enumerate(VARIANTS.values())))
    for name, so in zip(VARIANTS, libs):
        fn = ctypes.CDLL(str(so)).kfs_expm_pade
        fn.argtypes = lib.kfs_expm_pade.argtypes
        fn.restype = ctypes.c_int
        lib.kfs_expm_pade = fn
        print(f"[ab_expm] {name}: max rel err vs plain "
              f"{_accuracy(expm):.2e}; toggle t=1000: {_toggle()}",
              flush=True)
    stepper.expm_pade = expm.expm_pade_plain
    print(f"[ab_expm] plain version: toggle t=1000: {_toggle()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
