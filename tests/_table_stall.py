"""The table backend's stall at the two-sided FSP criterion's ceiling, held
in both packages (ROADMAP.md Queue C, "Mass above 1").

    python tests/_table_stall.py [--t 1000] [--seed 0]

On the CPU, for the toggle model of TestSolverFromFile (fsp_tol 1e-4,
krylov_tol 1e-10), in the stepwise loop of each package:

1. the JAX package's own solve: its steps and final wsum;
2. the port's solve, with a snapshot after every accepted step, until it
   ends or its stall guard raises;
3. every step of the port's that gained mass: the gain seen, and the gain
   exp(tau * h11) - 1 that an m=1 Arnoldi breakdown gives, with the
   Rayleigh quotient h11 = v1' A v1 of the step's start vector;
4. the JAX package resumed from the snapshot before each of the last four
   such steps: its next accepted step beside the port's;
5. the JAX package resumed from the port's last snapshot, stopped at the
   16th expansion: the steps it accepted in between.

Not a test (it takes minutes); ``tests/test_torch_table_solve.py`` holds
the port's guard.
"""

from __future__ import annotations

import argparse
import functools
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

import krylovfspssa_tpu.solver as jsolver  # noqa: E402
import krylovfspssa_tpu_torch.checkpoint as tckpt  # noqa: E402
from krylovfspssa_tpu.config import SolverConfig as JConfig  # noqa: E402
from krylovfspssa_tpu.models.library import (  # noqa: E402
    toggle_file_model as jtoggle,
)
from krylovfspssa_tpu_torch import CmeSolver, SolverConfig  # noqa: E402
from krylovfspssa_tpu_torch.models.library import (  # noqa: E402
    toggle_file_model,
)
from krylovfspssa_tpu_torch.ops.spmv import spmv  # noqa: E402
from krylovfspssa_tpu_torch.statespace.table import StateTable  # noqa: E402

TOL = dict(fsp_tol=1e-4, krylov_tol=1e-10)


class _Stop(Exception):
    pass


def jax_own(t, seed):
    t0 = time.perf_counter()
    r = jsolver.solve_cme(jtoggle(), t, [[0, 0]], **TOL,
                          config=JConfig(seed=seed, fused_steps=False))
    s = r.stats
    print(f"[jax] own solve to t={t:g}: iflag {s.iflag}, {s.nstep} steps, "
          f"wsum {r.probabilities.sum():.10f}, "
          f"{time.perf_counter() - t0:.1f} s")


def port_with_snapshots(t, seed, out: Path):
    """The port's stepwise solve, a snapshot per accepted step in ``out``
    (``s.<nstep>.npz``); returns the sorted snapshot paths."""
    real = tckpt.save_table_checkpoint

    def save(path, states, w, carry, *rest):
        real(out / f"s.{int(carry.nstep):05d}.npz", states, w, carry, *rest)

    tckpt.save_table_checkpoint = save
    t0 = time.perf_counter()
    try:
        r = CmeSolver(toggle_file_model(),
                      SolverConfig(seed=seed, fused_steps=False),
                      device="cpu").solve(
            t, [[0, 0]], **TOL, checkpoint_path=str(out / "unused"),
            checkpoint_every=1)
        print(f"[port] solve to t={t:g} ended: {r.stats.nstep} steps, "
              f"wsum {r.wsum:.10f}")
    except RuntimeError as e:
        print(f"[port] solve to t={t:g} raised: {e}")
    finally:
        tckpt.save_table_checkpoint = real
    print(f"[port] {time.perf_counter() - t0:.1f} s")
    return sorted(out.glob("s.*.npz"))


def h11_of(path):
    """(wsum, h11) of a snapshot's vector under the port's operator."""
    z = np.load(path)
    model = toggle_file_model()
    solver = CmeSolver(model, device="cpu")
    solver._dtype = torch.float64
    solver._props_fn = functools.partial(
        model.propensities,
        params=torch.as_tensor(np.asarray(model.parameters),
                               dtype=torch.float64))
    table = StateTable.from_states(z["states"], solver.encoder, 16, None)
    op, vl = solver._operator(table)
    w = vl.put(np.asarray(z["w"], np.float64))
    v = w / torch.linalg.norm(w)
    return float(w.sum()), float(torch.dot(v, spmv(op, v)))


def carry_of(path):
    z = np.load(path)
    return float(z["carry_t_now"]), float(z["carry_wsum_old"])


def jax_next_step(path, t, seed):
    """The JAX package's next accepted step from a snapshot: (t_now,
    wsum)."""
    solver = jsolver.CmeSolver(jtoggle(), JConfig(seed=seed,
                                                  fused_steps=False))
    inner, got = solver._step, {}

    def spy(*a, **k):
        res = inner(*a, **k)
        if bool(res.advanced):
            got.update(t=float(res.carry.t_now), wsum=float(res.wsum))
            raise _Stop
        return res

    solver._step = spy
    try:
        solver.solve(t, None, resume_from=str(path), verbosity=0)
    except _Stop:
        pass
    return got["t"], got["wsum"]


def jax_from_stall(path, t, seed, limit=16):
    """Resume the JAX package from ``path`` and stop at its ``limit``-th
    expansion; returns (accepted steps, expansions, table size)."""
    solver = jsolver.CmeSolver(jtoggle(), JConfig(seed=seed,
                                                  fused_steps=False))
    inner, seen = solver._step, {"acc": 0, "exp": 0, "n": 0}
    real = jsolver.onestep_extend

    def spy(*a, **k):
        res = inner(*a, **k)
        seen["acc"] += int(bool(res.advanced))
        return res

    def counted(table, *a, **k):
        out = real(table, *a, **k)
        seen["exp"] += 1
        seen["n"] = out[0].n
        if seen["exp"] >= limit:
            raise _Stop
        return out

    solver._step = spy
    jsolver.onestep_extend = counted
    try:
        solver.solve(t, None, resume_from=str(path), verbosity=0)
    except _Stop:
        pass
    finally:
        jsolver.onestep_extend = real
    return seen["acc"], seen["exp"], seen["n"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=float, default=1000.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    jax_own(args.t, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        snaps = port_with_snapshots(args.t, args.seed, Path(tmp))
        gains = []
        for prev, cur in zip(snaps, snaps[1:]):
            (t0, w0), (t1, w1) = carry_of(prev), carry_of(cur)
            if w1 > w0 + 1e-9:
                wsum, h11 = h11_of(prev)
                gains.append((prev, cur))
                want = wsum * np.expm1((t1 - t0) * h11)
                print(f"[gain] step to t={t1:.4f} (tau {t1 - t0:.4g}): "
                      f"gained {w1 - w0:.6e}; exp(tau*h11)-1 with h11 "
                      f"{h11:.6e} gives {want:.6e}")
        for prev, cur in gains[-4:]:
            jt, jw = jax_next_step(prev, args.t, args.seed)
            pt, pw = carry_of(cur)
            print(f"[resumed] from {prev.name}: JAX t={jt:.4f} wsum "
                  f"{jw:.12f}; port t={pt:.4f} wsum {pw:.12f}")
        t_last, w_last = carry_of(snaps[-1])
        ceiling = TOL["fsp_tol"] * t_last / args.t
        print(f"[stall] port's last snapshot: t={t_last:.4f}, wsum "
              f"{w_last:.12f}, ceiling 1 + {ceiling:.10e}")
        acc, nexp, n = jax_from_stall(snaps[-1], args.t, args.seed)
        print(f"[stall] JAX resumed there: {acc} accepted steps in {nexp} "
              f"expansions (table {n} states)")


if __name__ == "__main__":
    main()
