"""The benchmark of krylovfspssa_tpu_torch: one cell, run once.

A cell is a configuration (``configs/<config>.py``: the network, its
published parameters, x0, tolerances and dtype) under a traffic mix
(``traffic/<traffic>.json``: the entry, the horizon and the parameter
jitter), with its comparison limits in ``workloads/<cell>.json``.
``BENCHMARK.json`` at the root of the checkout names them; this module
finds every file by those names, so a new cell, configuration, traffic
mix or per-layer metric (``metrics/<metric>.py``) is a new file.

Traffic is a closed loop with one client: solves back to back, each
waiting for the one before it.  Solve i calls the program's public entry
anew, from the configuration's x0, with every published rate constant
multiplied by its own factor, drawn log-uniformly from [1/jitter,
jitter] by a generator keyed on (seed, i); on the table the solver's own
seed comes from the same key.  Solve 0 is the warm-up; solves 1, 2, ...
fill the window, and none starts after it has closed.  In a cell whose
end-to-end metrics include one read from the device's trace, the window
runs under a profiler that traces the card alone (``--trace 0`` runs).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level modules that must not be loaded in a run of the port
FORBIDDEN = ("jax", "jaxlib", "flax", "krylovfspssa_tpu")


def load_module(kind: str, name: str):
    """``cme_bench/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    key = "cme_bench_" + kind + "_" + "".join(
        c if c.isalnum() else "_" for c in name)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: object  #: the configuration's module
    reference: object  #: its plain reference's module
    traffic: dict
    limits: dict  #: comparison limits (``workloads/<cell>.json``)
    end_to_end: list  #: BENCHMARK.json's end-to-end metrics of this cell
    per_layer: list  #: and its per-layer metrics

    @property
    def t_out(self) -> float:
        return float(self.traffic["t_out"])


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_module("configs", w["config"]),
        reference=load_module("reference", w["config"]),
        traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])


# ------------------------------------------------------------------ #
#                              traffic                               #
# ------------------------------------------------------------------ #

def draw(seed: int, i: int, n_params: int, jitter: float):
    """(factors on the published rate constants, solver seed) of solve i."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, int(i)])
    half = math.log(jitter)
    factors = np.exp(rng.uniform(-half, half, n_params))
    return factors, int(rng.integers(0, 2 ** 31 - 1))


def parameters(c: Cell, seed: int, i: int):
    """(rate constants, solver seed) of solve i."""
    published = np.asarray(c.config.PARAMETERS, dtype=np.float64)
    factors, solver_seed = draw(seed, i, published.size,
                                float(c.traffic["jitter"]))
    return published * factors, solver_seed


# ------------------------------------------------------------------ #
#                          one solve, gated                          #
# ------------------------------------------------------------------ #

def counters() -> dict:
    from krylovfspssa_tpu_torch.krylov import stepper
    from krylovfspssa_tpu_torch.ops import expm, spmv, stencil_cuda

    return {"stencil": (stencil_cuda.LAUNCHES + stencil_cuda.DIRECT_LAUNCHES
                        + stencil_cuda.HALO_LAUNCHES),
            "expm": expm.LAUNCHES, "spmv": spmv.CALLS,
            "retakes": sum(stepper.RETAKES.values())}


@dataclasses.dataclass
class Solve:
    """One solve of the window: its draw, wall, counts and answer."""

    i: int
    params: np.ndarray
    wall: float
    counts: dict
    states: np.ndarray | None = None
    probabilities: np.ndarray | None = None
    fault: str | None = None  #: why the gate failed it, if it did


def run_solve(c: Cell, model, seed: int, i: int, device: str,
              dtype: str | None = None) -> Solve:
    """Solve i through the program's public entry; gated."""
    import torch

    from krylovfspssa_tpu_torch import SolverConfig, solve_cme, solve_cme_box

    params, solver_seed = parameters(c, seed, i)
    cfg = c.config
    model.reset_parameters(params)
    config = SolverConfig(dtype=dtype or cfg.DTYPE, seed=solver_seed)
    entry = {"box": solve_cme_box, "table": solve_cme}[c.traffic["entry"]]
    before = counters()
    t0 = time.perf_counter()
    try:
        res = entry(model, c.t_out, [cfg.X0], fsp_tol=cfg.FSP_TOL,
                    krylov_tol=cfg.KRYLOV_TOL, config=config, device=device)
        if str(device).startswith("cuda"):
            torch.cuda.synchronize()
    except Exception as e:  # a solve that fails is counted, not fatal
        return Solve(i, params, time.perf_counter() - t0, {},
                     fault=f"{type(e).__name__}: {e}")
    wall = time.perf_counter() - t0
    after = counters()
    s = res.stats
    counts = {"nstep": s.nstep, "nmult": s.nmult, "nreject": s.nreject,
              "nexph": s.nexph, "expansions": s.n_expansions,
              "drops": s.n_drops, "fsp": s.final_fsp_size,
              "retakes": after["retakes"] - before["retakes"],
              "wsum": res.wsum, "iflag": s.iflag}
    if c.traffic["entry"] == "box":
        counts["box"] = int(res.box.volume)
    launched = {k: after[k] - before[k] for k in ("stencil", "expm", "spmv")}
    out = Solve(i, params, wall, counts, res.states, res.probabilities)
    out.fault = gate(c, res, launched, str(device).startswith("cuda"))
    return out


def gate(c: Cell, res, launched: dict, on_card: bool) -> str | None:
    """PERF.md's gate of one solve: iflag 0, finite probabilities, wsum
    within fsp_tol of 1, and on the card every matvec through the entry's
    operator (a stencil kernel on the box, the ELL SpMV and no stencil on
    the table) and every exponential through ``expm_pade``."""
    s = res.stats
    tol = c.config.FSP_TOL
    if s.iflag != 0:
        return f"iflag {s.iflag}"
    if not np.all(np.isfinite(res.probabilities)):
        return "non-finite probabilities"
    if not 1 - tol <= res.wsum <= 1 + tol:
        return f"wsum {res.wsum!r} outside 1 +- {tol:g}"
    if not on_card:
        return None
    if c.traffic["entry"] == "box" and launched["stencil"] < s.nmult:
        return f"{launched['stencil']} stencil launches < nmult {s.nmult}"
    if c.traffic["entry"] == "table":
        if launched["stencil"]:
            return f"{launched['stencil']} stencil launches on the table"
        if launched["spmv"] < s.nmult:
            return f"{launched['spmv']} SpMV calls < nmult {s.nmult}"
    if launched["expm"] < s.nexph:
        return f"{launched['expm']} expm_pade launches < nexph {s.nexph}"
    return None


def solve_line(sv: Solve) -> str:
    counts = " ".join(f"{k} {v}" for k, v in sv.counts.items())
    state = f"FAILED ({sv.fault})" if sv.fault else "ok"
    return f"solve {sv.i}: wall {sv.wall!r} s {counts} {state}"


# ------------------------------------------------------------------ #
#                     the window and its metrics                     #
# ------------------------------------------------------------------ #

def window(c: Cell, model, seed: int, seconds: float, device: str,
           dtype: str | None = None, log=print):
    """Solves 1, 2, ... back to back until ``seconds`` have passed; returns
    (the solves, the window's wall up to the end of the last one)."""
    solves = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        sv = run_solve(c, model, seed, len(solves) + 1, device, dtype)
        solves.append(sv)
        log(solve_line(sv))
    return solves, time.perf_counter() - t0


def device_timed(c: Cell) -> bool:
    """Whether one of the cell's end-to-end metrics is read from the
    device's trace of the window."""
    return any(m["source"] == "device_trace" for m in c.end_to_end)


def end_to_end(c: Cell, solves, window_s: float, setup_s: float,
               device_s: float | None = None) -> dict:
    """The cell's end-to-end metrics over the solves that completed;
    ``device_s`` is the card's busy seconds over the whole window, where
    it was traced."""
    done = [sv.wall for sv in solves if sv.counts]
    values = {"setup_s": setup_s}
    if done:
        values["solve_s"] = window_s / len(done)
        values["solve_s_p95"] = p95(done)
        if device_s is not None:
            values["device_s_per_solve"] = device_s / len(done)
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in c.end_to_end if m["name"] in values}


def p95(walls) -> float:
    """The 95th percentile of the walls, linear between order statistics."""
    if len(walls) == 1:
        return float(walls[0])
    return statistics.quantiles(walls, n=20, method="inclusive")[-1]


# ------------------------------------------------------------------ #
#                             comparison                             #
# ------------------------------------------------------------------ #

def sample(solves, seed: int, size: int):
    """The solves that are compared: all of them, or ``size`` drawn from
    the seed."""
    if len(solves) <= size:
        return list(solves)
    rng = np.random.default_rng([int(seed) % 2 ** 64, 2 ** 32])
    pick = np.sort(rng.choice(len(solves), size=size, replace=False))
    return [solves[j] for j in pick]


def reference(c: Cell, params, device: str, dtype=None):
    """The plain reference's distributions of the parameter sets."""
    import torch

    from cme_bench.reference import fsp

    net = fsp.Network(c.reference.STOICHIOMETRY, c.reference.propensities)
    return fsp.solve(net, c.config.X0, c.t_out, params, c.reference.BOUNDS,
                     device=device, dtype=dtype or torch.float64)


def excess(states, probabilities, sol, k: int) -> float:
    """The mass an answer puts above reference solution k, summed over
    states.  An FSP answer is a lower bound of the exact distribution
    whose total shortfall is its own 1 - wsum (which the gate holds to
    fsp_tol), so its L1 distance to the reference is 1 - wsum + 2 x its
    excess: the excess is the rest of its error, round-off and time
    integration, apart from the truncation that fsp_tol allows."""
    idx = sol.lookup(states)
    ref = np.where(idx >= 0, sol.p[k][np.maximum(idx, 0)], 0.0)
    diff = np.asarray(probabilities, dtype=np.float64) - ref
    return float(np.maximum(diff, 0).sum())


def excesses(c: Cell, params, answers, device: str) -> list:
    """The excess of each answer (states, probabilities) to the parameter
    sets ``params`` over the reference."""
    sol = reference(c, params, device)
    return [excess(s, p, sol, k) for k, (s, p) in enumerate(answers)]


def checks(c: Cell, solves, seed: int, device: str, log=print) -> dict:
    """{name: (value, limit)} of a run: the solves that failed the gate,
    and the largest excess over a sample of the rest."""
    out = {"gate_failures": (sum(1 for sv in solves if sv.fault), 0)}
    judged = sample([sv for sv in solves if not sv.fault], seed,
                    int(c.limits["sample"]))
    if not judged:
        return out
    got = excesses(c, [sv.params for sv in judged],
                   [(sv.states, sv.probabilities) for sv in judged], device)
    for sv, ex in zip(judged, got):
        log(f"compare solve {sv.i}: excess {ex!r}")
    out["excess"] = (max(got), float(c.limits["limits"]["excess"]))
    return out


def passed(checks_: dict) -> bool:
    return all(v <= lim for v, lim in checks_.values())


# ------------------------------------------------------------------ #
#                               trace                                #
# ------------------------------------------------------------------ #

@dataclasses.dataclass
class Trace:
    """What the per-layer readers read: one profiled solve (``profile``,
    its ``counts``) and the same draw again under the spans (``spans``:
    name -> seconds of each call)."""

    profile: object
    counts: dict
    spans: dict


#: program functions timed as spans in the traced run's second solve
#: (module, attribute): the card is synchronised around each call
SPANS = (("krylovfspssa_tpu_torch.solver", "ssa_extend"),
         ("krylovfspssa_tpu_torch.solver", "onestep_extend"),
         ("krylovfspssa_tpu_torch.solver", "build_operator"))


def spanned(fn):
    """Run ``fn()`` with every ``SPANS`` function timed; returns (its
    result, {name: [seconds of each call]})."""
    import importlib

    import torch

    spans = {}
    saved = []
    for mod_name, attr in SPANS:
        mod = importlib.import_module(mod_name)
        inner = getattr(mod, attr)
        saved.append((mod, attr, inner))
        spans[attr] = []

        def timed(*args, _inner=inner, _times=spans[attr], **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _inner(*args, **kwargs)
            torch.cuda.synchronize()
            _times.append(time.perf_counter() - t0)
            return out
        setattr(mod, attr, timed)
    try:
        return fn(), spans
    finally:
        for mod, attr, inner in saved:
            setattr(mod, attr, inner)


def trace(c: Cell, model, seed: int, device: str, log=print) -> Trace:
    """Profile solve 1 of the window's draws, then run it again under the
    spans; both must take the same steps and matvecs."""
    from cme_bench import devtrace

    sv, prof = devtrace.profiled(
        lambda: run_solve(c, model, seed, 1, device))
    log("traced " + solve_line(sv))
    again, spans = spanned(lambda: run_solve(c, model, seed, 1, device))
    log("spanned " + solve_line(again))
    for key in ("nstep", "nmult"):
        if sv.counts.get(key) != again.counts.get(key):
            raise RuntimeError(f"the traced and spanned solves differ in "
                               f"{key}: {sv.counts} vs {again.counts}")
    return Trace(prof, sv.counts, spans)


def per_layer(c: Cell, tr: Trace) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in c.per_layer:
        reader = load_module("metrics", m["name"])
        value = reader.read(tr)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# ------------------------------------------------------------------ #
#                               a run                                #
# ------------------------------------------------------------------ #

def forbidden_modules() -> list:
    return sorted({k.split(".", 1)[0] for k in sys.modules}
                  & set(FORBIDDEN))


def run(c: Cell, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda", log=print) -> dict:
    """One run of a cell; returns the result line's object.  ``t_start``
    is the process's start on the host clock."""
    import torch

    on_card = device.startswith("cuda")
    t_imports = time.perf_counter()
    if on_card:
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    t_context = time.perf_counter()
    model = c.config.model()
    warm = run_solve(c, model, seed, 0, device)
    log("warm-up " + solve_line(warm))
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s!r} s: imports {t_imports - t_start!r} s, CUDA "
        f"context {t_context - t_imports!r} s, warm-up solve {warm.wall!r} s "
        f"(in a checkout's first run it builds the kernels)")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    device_s = None
    if on_card and not traced and device_timed(c):
        from cme_bench import devtrace

        (solves, window_s), device_s = devtrace.device_busy(
            lambda: window(c, model, seed, seconds, device, log=log))
        log(f"device busy {device_s!r} s over the window's {window_s!r} s")
    else:
        solves, window_s = window(c, model, seed, seconds, device, log=log)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    result = {"correct": False, "attempted": len(solves),
              "failed": sum(1 for sv in solves if sv.fault)}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": c.chips, "memory_peak_bytes": peak}
    if traced:
        tr = trace(c, model, seed, device, log=log)
        result["metrics"] = per_layer(c, tr)
        device_info["busy_s"] = tr.profile.busy_s
        device_info["window_s"] = tr.profile.window_s
        from cme_bench import devtrace

        result["breakdown"] = {
            "device_ops": devtrace.top(
                {k: v[1] for k, v in tr.profile.device_ops.items()}),
            "idle_gaps": devtrace.top(tr.profile.idle_by_host)}
    else:
        result["metrics"] = end_to_end(c, solves, window_s, setup_s,
                                       device_s)
    result["device"] = device_info
    del model
    if on_card:
        torch.cuda.empty_cache()
    got = checks(c, solves, seed, device, log=log)
    result["correct"] = passed(got)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in got.items()}
    return result
