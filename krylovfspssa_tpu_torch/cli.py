"""Command-line interface of the PyTorch port — ``kfs-torch``.

``kfs-torch solve`` replicates ``test/TestSolverFromFile.f90``: load a model
(``.input`` file or built-in library name), solve the CME to a final time
on the box backend, print per-step statistics and the elapsed wall time,
optionally save the final (states, probabilities) to ``.npz``.  It takes
the flags of the JAX package's ``kfs solve`` plus ``--device`` (default
``cuda``); the table backend and multi-device flags are not ported yet and
raise ``NotImplementedError``.

``kfs-torch models`` lists the built-in model library; ``kfs-torch info``
prints a model summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _load(spec: str, params: list[float] | None):
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
            print(
                f"kfs: using reference-driver parameters for {path.stem}: "
                f"{params} (override with --params)"
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


def cmd_solve(args) -> int:
    from .boxsolver import solve_cme_box
    from .config import SolverConfig

    if args.backend != "box":
        raise NotImplementedError(
            "the table backend is not ported yet (ROADMAP.md Queue A, "
            "slice 3)"
        )
    if args.devices or args.multihost:
        raise NotImplementedError(
            "multi-device solves are not ported yet (ROADMAP.md Queue A, "
            "slice 4)"
        )
    model = _load(args.model, args.params)
    x0 = _parse_state(args.x0, model.n_species)
    cfg_kwargs = {}
    if args.dtype:
        cfg_kwargs["dtype"] = args.dtype
    if args.no_fused:
        cfg_kwargs["fused_steps"] = False
    if args.table_operator:
        cfg_kwargs["table_operator"] = args.table_operator
    config = SolverConfig(**cfg_kwargs)

    kwargs = {}
    if args.checkpoint:
        kwargs["checkpoint_path"] = args.checkpoint
        kwargs["checkpoint_every"] = args.checkpoint_every
    if args.resume:
        kwargs["resume_from"] = args.resume

    import contextlib

    profile_cm = contextlib.nullcontext()
    if args.profile:
        import torch.profiler as tp

        profile_cm = tp.profile(
            on_trace_ready=tp.tensorboard_trace_handler(args.profile)
        )

    t0 = time.perf_counter()
    with profile_cm:
        res = solve_cme_box(
            model,
            args.t,
            x0,
            fsp_tol=args.fsp_tol,
            krylov_tol=args.krylov_tol,
            config=config,
            verbosity=args.verbose,
            device=args.device,
            **kwargs,
        )
    wall = time.perf_counter() - t0

    if args.log_steps:
        import dataclasses as _dc

        with open(args.log_steps, "w") as fh:
            for rec in res.stats.records:
                fh.write(json.dumps(_dc.asdict(rec)) + "\n")

    s = res.stats
    print(f"model          : {model.name or args.model}")
    print(f"backend        : {args.backend} ({args.device})")
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
        try:
            m = get_model(name)
            print(f"{name:28s} {m.n_species} species, "
                  f"{m.n_reactions} reactions")
        except NotImplementedError as e:  # custom propensities (kernel B5)
            print(f"{name:28s} NOT PORTED: {e}")
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
                    help="state-space backend (only box is ported)")
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
                    help="row-partition the solve over N devices (not "
                    "ported yet)")
    ps.add_argument("--multihost", action="store_true",
                    help="mesh over all devices of all processes (not "
                    "ported yet)")
    ps.add_argument("--no-fused", action="store_true",
                    help="disable the fused device main loop (the port "
                    "always runs the stepwise loop)")
    ps.add_argument("--table-operator", choices=("auto", "ell", "pencil"),
                    help="table-backend operator representation (the "
                    "table backend is not ported yet)")
    ps.add_argument("-v", "--verbose", action="count", default=0)
    ps.add_argument("-o", "--output", help="save result to .npz")
    ps.add_argument("--json", action="store_true",
                    help="also print a JSON summary line")
    ps.add_argument("--checkpoint", help="write solve snapshots to this .npz")
    ps.add_argument("--checkpoint-every", type=int, default=50,
                    help="steps between snapshots (default 50)")
    ps.add_argument("--resume", help="resume a solve from a snapshot .npz")
    ps.add_argument("--profile",
                    help="write a torch.profiler trace to this directory")
    ps.add_argument("--log-steps",
                    help="write per-step records as JSON lines to this file")
    ps.set_defaults(fn=cmd_solve)

    pm = sub.add_parser("models", help="list built-in models")
    pm.set_defaults(fn=cmd_models)

    pi = sub.add_parser("info", help="print a model summary")
    pi.add_argument("model")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
