"""Command-line interface of the PyTorch port — ``kfs-torch``.

``kfs-torch solve`` replicates ``test/TestSolverFromFile.f90``: load a model
(``.input`` file or built-in library name), solve the CME to a final time
on the box backend (``--backend box``, the default) or the table backend
(``--backend table``: a sorted state table with SSA expansion and the
gather-ELL or, with ``--table-operator pencil``, the pencil operator,
solver.py), print per-step statistics and the elapsed wall time,
optionally save the final (states, probabilities) to ``.npz``.  It takes
the flags of the JAX package's ``kfs solve`` plus ``--device`` (default
``cuda``).

``--devices N`` row-shards the solve (either backend) over N ranks of
this host, one process each (parallel/multihost.py ``spawn``): one card
per rank with NCCL, or gloo ranks on the CPU with ``--device cpu``.
``--multihost`` joins the process group that ``torchrun`` describes;
every process then solves its rows on ``--device`` and rank 0 prints
(without torchrun's variables it is a mesh of one rank on ``--device``).

``kfs-torch models`` lists the built-in model library (all seven models,
custom-propensity ones included, solve on both devices); ``kfs-torch
info`` prints a model summary; ``kfs-torch bench`` times the stencil
kernels against the stored-CSR memory roofline (bench.py).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np


def _load(spec: str, params: list[float] | None, quiet: bool = False):
    from .models.library import DRIVER_PARAMETERS, LIBRARY, get_model
    from .models.model import load_model

    if spec in LIBRARY:
        model = get_model(spec)
    else:
        path = Path(spec)
        if not path.exists():
            raise SystemExit(
                f"kfs: {spec!r} is neither a built-in model "
                f"({sorted(LIBRARY)}) nor a file"
            )
        model = load_model(path)
        if params is None and path.stem in DRIVER_PARAMETERS:
            # the .input format carries parameter names only; apply the
            # values the reference driver resets this model to (e.g.
            # TestSolverFromFile.f90:31) so `kfs solve models/x.input`
            # solves the same CME as the corresponding driver program
            params = DRIVER_PARAMETERS[path.stem]
            if not quiet:
                print(
                    f"kfs: using reference-driver parameters for "
                    f"{path.stem}: {params} (override with --params)"
                )
    if params is not None:
        model.reset_parameters(params)
    return model


def _parse_state(text: str | None, n_species: int) -> np.ndarray:
    if text is None:
        return np.zeros((1, n_species), dtype=np.int64)
    x0 = np.array([int(v) for v in text.replace(",", " ").split()])
    if x0.size != n_species:
        raise SystemExit(
            f"kfs: --x0 has {x0.size} entries, model has {n_species} species"
        )
    return x0[None, :]


def _solve_kwargs(args) -> dict:
    """The solve's keyword arguments from the command line."""
    from .config import SolverConfig

    cfg_kwargs = {}
    if args.dtype:
        cfg_kwargs["dtype"] = args.dtype
    if args.no_fused:
        cfg_kwargs["fused_steps"] = False
    if args.table_operator:
        cfg_kwargs["table_operator"] = args.table_operator
    kwargs = dict(
        fsp_tol=args.fsp_tol,
        krylov_tol=args.krylov_tol,
        config=SolverConfig(**cfg_kwargs),
        verbosity=args.verbose,
    )
    if args.checkpoint:
        kwargs["checkpoint_path"] = args.checkpoint
        kwargs["checkpoint_every"] = args.checkpoint_every
    if args.resume:
        kwargs["resume_from"] = args.resume
    return kwargs


@contextlib.contextmanager
def _profiled(profile_dir):
    """torch.profiler writing its trace to ``profile_dir``, with the
    solver's spans recorded (utils/trace.py), so the trace names the
    layers (``kfs::step``, ``kfs::replay``, ...); nothing without a
    directory."""
    if not profile_dir:
        yield
        return
    import torch.profiler as tp

    from .utils import trace

    with trace.recording(), tp.profile(
            on_trace_ready=tp.tensorboard_trace_handler(profile_dir)):
        yield


def _solve_rank(mesh, args):
    """One rank of ``solve --devices N``: the sharded solve of this rank's
    rows.  Rank 0 returns the result (every rank holds the whole of it),
    the others None; only rank 0 prints steps and writes the profile."""
    model = _load(args.model, args.params, quiet=True)
    kwargs = _solve_kwargs(args)
    if mesh.rank:
        kwargs["verbosity"] = 0
    with _profiled(args.profile if mesh.rank == 0 else None):
        res = _solver(args.backend)(
            model, args.t, _parse_state(args.x0, model.n_species),
            mesh=mesh, **kwargs)
    return res if mesh.rank == 0 else None


def _solver(backend: str):
    """The library entry point of ``--backend``: ``solve_cme_box`` or
    ``solve_cme``, each taking (model, t, x0, mesh=..., device=...)."""
    if backend == "table":
        from .solver import solve_cme

        return solve_cme
    from .boxsolver import solve_cme_box

    return solve_cme_box


def _spawn_ranks(args):
    """Rank 0's result of ``solve --devices N`` on this host."""
    import torch

    from .parallel.multihost import spawn

    n = args.devices
    if torch.device(args.device).type == "cuda":
        visible = torch.cuda.device_count()
        if n > visible:
            raise SystemExit(
                f"kfs-torch: --devices {n} requested but only {visible} "
                "CUDA devices visible (--device cpu runs gloo ranks on the "
                "CPU)"
            )
        devices, backend = [f"cuda:{r}" for r in range(n)], "nccl"
    else:
        devices, backend = [args.device] * n, "gloo"
    return spawn(_solve_rank, devices, (args,), backend=backend)[0]


def cmd_solve(args) -> int:
    model = _load(args.model, args.params)
    x0 = _parse_state(args.x0, model.n_species)
    solve = _solver(args.backend)

    t0 = time.perf_counter()
    if args.multihost:
        import torch

        from .parallel import multihost

        on_cpu = torch.device(args.device).type == "cpu"
        multihost.initialize(backend="gloo" if on_cpu else None)
        # the mesh is on the device asked for, launched or not: a run
        # without torchrun's variables is one rank there
        mesh = multihost.global_mesh(args.device)
        with _profiled(args.profile if mesh.rank == 0 else None):
            res = solve(model, args.t, x0, mesh=mesh, **_solve_kwargs(args))
        if mesh.rank:
            return 0
    elif args.devices:
        res = _spawn_ranks(args)
    else:
        with _profiled(args.profile):
            res = solve(model, args.t, x0, device=args.device,
                        **_solve_kwargs(args))
    wall = time.perf_counter() - t0

    if args.log_steps:
        import dataclasses as _dc

        with open(args.log_steps, "w") as fh:
            for rec in res.stats.records:
                fh.write(json.dumps(_dc.asdict(rec)) + "\n")

    s = res.stats
    print(f"model          : {model.name or args.model}")
    ranks = f", {args.devices} ranks" if args.devices else ""
    print(f"backend        : {args.backend} ({args.device}{ranks})")
    print(f"t_final        : {s.t_final:g}")
    print(f"final FSP size : {s.final_fsp_size}")
    print(f"wsum           : {res.wsum:.10f}   (1-wsum = {1 - res.wsum:.3e})")
    print(f"steps          : {s.nstep}  (rejections {s.nreject}, "
          f"expansions {s.n_expansions}, drops {s.n_drops})")
    print(f"matvecs        : {s.nmult}   expm evals: {s.nexph}")
    print(f"step size      : [{s.step_min:.3g}, {s.step_max:.3g}]")
    print(f"elapsed        : {wall:.3f} s")

    if args.output:
        np.savez_compressed(
            args.output,
            states=res.states,
            probabilities=res.probabilities,
            t=res.t,
            wsum=res.wsum,
        )
        print(f"saved          : {args.output}")
    if args.json:
        rec = {
            "model": model.name or args.model,
            "backend": args.backend,
            "device": args.device,
            "ranks": args.devices or 1,
            "t": s.t_final,
            "fsp_size": s.final_fsp_size,
            "wsum": res.wsum,
            "nstep": s.nstep,
            "nreject": s.nreject,
            "nmult": s.nmult,
            "wall_s": wall,
        }
        print(json.dumps(rec))
    return 0


def cmd_models(args) -> int:
    from .models.library import LIBRARY, get_model

    for name in sorted(LIBRARY):
        m = get_model(name)
        kind = "custom propensity" if m.custom_propensity else "expressions"
        print(f"{name:28s} {m.n_species} species, "
              f"{m.n_reactions} reactions ({kind})")
    return 0


def cmd_info(args) -> int:
    model = _load(args.model, None)
    print(f"name       : {model.name}")
    print(f"species    : {', '.join(model.species_names)}")
    print(f"parameters : "
          + ", ".join(
              f"{n}={v:g}"
              for n, v in zip(model.parameter_names, model.parameters)
          ))
    print("reactions  :")
    stoich = np.asarray(model.stoichiometry)
    for k in range(model.n_reactions):
        nu = stoich[k]
        terms = [
            f"{'+' if v > 0 else ''}{v} {s}"
            for v, s in zip(nu, model.species_names)
            if v != 0
        ]
        expr = (
            model.propensity_expressions[k]
            if model.propensity_expressions
            else "<custom>"
        )
        print(f"  R{k + 1}: {', '.join(terms) or '(null)'}    a = {expr}")
    return 0


def cmd_bench(args) -> int:
    from .bench import run

    return run(args)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="kfs-torch",
        description="Krylov-FSP solver for the Chemical Master Equation "
        "(PyTorch/CUDA port)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("solve", help="solve a CME model to a final time")
    ps.add_argument("model", help=".input file path or built-in model name")
    ps.add_argument("--t", type=float, default=1000.0,
                    help="final time T_OUT (default 1000, the "
                    "TestSolverFromFile setting)")
    ps.add_argument("--fsp-tol", type=float, default=1e-4)
    ps.add_argument("--krylov-tol", type=float, default=1e-10)
    ps.add_argument("--x0", help="initial state, e.g. '0,0' (default all 0)")
    ps.add_argument("--params", type=float, nargs="+",
                    help="override model parameters")
    ps.add_argument("--backend", choices=("box", "table"), default="box",
                    help="state-space backend: box (default) = a masked "
                    "power-of-two box with the stencil kernels; table = a "
                    "sorted state table grown by SSA walks and 1-step "
                    "reachability, with the gather-ELL or pencil "
                    "operator)")
    ps.add_argument("--device", default="cuda",
                    help="torch device of the solve (default cuda; cpu "
                    "runs the plain PyTorch stencil)")
    ps.add_argument("--dtype", choices=("auto", "float64", "float32"),
                    help="probability-vector dtype. auto (default) = "
                    "float32 on a GPU, float64 on CPU; float32 certifies "
                    "fsp_tol only down to ~1.5e-5 (the per-step noise "
                    "floor is reserved out of the budget, so the FSP "
                    "guarantee stays exactly fsp_tol) — tighter requests "
                    "fall back to float64 under auto and are refused "
                    "under explicit float32")
    ps.add_argument("--devices", type=int, metavar="N",
                    help="row-partition the solve over N ranks of this "
                    "host: one card each (NCCL), or gloo ranks on the CPU "
                    "with --device cpu")
    ps.add_argument("--multihost", action="store_true",
                    help="row-partition the solve over the ranks of the "
                    "process group torchrun describes (one process per "
                    "card); rank 0 prints")
    ps.add_argument("--no-fused", action="store_true",
                    help="run the stepwise main loop (one attempted step "
                    "at a time; the box never shrinks) instead of the "
                    "default fused segments")
    ps.add_argument("--table-operator", choices=("auto", "ell", "pencil"),
                    help="table-backend operator representation: ell = "
                    "the reference-format gather-ELL; auto (default) = "
                    "ell on the CPU and the GPU; pencil = row gathers and "
                    "lane shifts (the JAX package's TPU form; ell under "
                    "--devices/--multihost)")
    ps.add_argument("-v", "--verbose", action="count", default=0)
    ps.add_argument("-o", "--output", help="save result to .npz")
    ps.add_argument("--json", action="store_true",
                    help="also print a JSON summary line")
    ps.add_argument("--checkpoint", help="write solve snapshots to this .npz")
    ps.add_argument("--checkpoint-every", type=int, default=50,
                    help="steps between snapshots (default 50)")
    ps.add_argument("--resume", help="resume a solve from a snapshot .npz")
    ps.add_argument("--profile",
                    help="write a torch.profiler trace to this directory, "
                    "the solver's layers named in it as kfs:: ranges")
    ps.add_argument("--log-steps",
                    help="write per-step records as JSON lines to this file")
    ps.set_defaults(fn=cmd_solve)

    pm = sub.add_parser("models", help="list built-in models")
    pm.set_defaults(fn=cmd_models)

    pi = sub.add_parser("info", help="print a model summary")
    pi.add_argument("model")
    pi.set_defaults(fn=cmd_info)

    from .bench import add_arguments

    pb = sub.add_parser("bench", help="time the stencil kernels against the "
                        "stored-CSR memory roofline (one JSON line)")
    add_arguments(pb)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
