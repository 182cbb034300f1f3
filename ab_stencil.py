#!/usr/bin/env python3
"""A/B timing of the separable stencil kernel (``box_stencil``) of several
checkouts of the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 ab_stencil.py DIR [DIR ...]

Each DIR holds a ``krylovfspssa_tpu_torch`` package (a checkout, or a
``git archive`` of another commit unpacked into a directory that
``.gitignore`` lists, such as ``build/``).  The script builds every
checkout's kernels at once (one nvcc each), then, with the first DIR, runs
the Goutsias t=10 solve (fsp_tol 1e-6, krylov_tol 1e-8) and the toggle
t=1000 solve (fsp_tol 1e-4, krylov_tol 1e-10) on the card and keeps the last
input (mask, x) each solve gave ``box_stencil``: the kernel's inputs on
those solve paths.  Then each DIR, in its own process, in the order
A B .. B A, times ``box_stencil`` (20 back-to-back launches between two
CUDA events behind ``torch.cuda._sleep``, median of 5) on

  * the 2^22-cell Goutsias box and a 512x512 toggle box, 60% of the cells
    active with every face of the box on, float64 and float32;
  * the two solves' last inputs, float64;

and checks it against its own plain version.  It prints one line per case
and checkout (microseconds per launch, each run) and writes them to
``chiprun_out/ab_stencil.json``.  Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SLEEP_CYCLES = 10_000_000


def _time_ms(fn, *args, warmup=3, launches=20, rounds=5):
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


def _grown(model, x0, targets):
    from krylovfspssa_tpu_torch.boxspace.box import BoxSpace

    box = BoxSpace.for_model(model.stoichiometry, x0)
    for s, tgt in enumerate(targets):
        while box.extents[s] < tgt:
            box = box.grow(s)
    return box


def _face_inputs(box, dt, seed=0):
    import numpy as np
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


def _solves():
    from krylovfspssa_tpu_torch.models.library import (
        goutsias_model,
        toggle_file_model,
    )

    return (("goutsias", goutsias_model(), 10.0, [[2, 6, 0, 2, 0, 0]],
             1e-6, 1e-8),
            ("toggle", toggle_file_model(), 1000.0, [[0, 0]], 1e-4, 1e-10))


def mode_build(tree):
    sys.path.insert(0, tree)
    from krylovfspssa_tpu_torch.ops import stencil_cuda as sc

    info = sc.build()
    print("\n".join(ln.strip() for ln in info.log.splitlines()
                    if "registers" in ln or "Compiling entry" in ln))


def mode_capture(tree, out):
    sys.path.insert(0, tree)
    import torch

    from krylovfspssa_tpu_torch import BoxCmeSolver
    from krylovfspssa_tpu_torch.ops import stencil_cuda as sc

    last = {}
    kernel = sc.box_stencil

    def keep_last(pack, mask, x):
        last["mask"], last["x"] = mask.clone(), x.clone()
        return kernel(pack, mask, x)

    sc.box_stencil = keep_last
    saved = {}
    for name, model, t, x0, fsp_tol, krylov_tol in _solves():
        t0 = time.perf_counter()
        res = BoxCmeSolver(model, device="cuda").solve(
            t, x0, fsp_tol=fsp_tol, krylov_tol=krylov_tol)
        torch.cuda.synchronize()
        saved[name] = dict(axis=list(res.box.axis_of_species),
                           log2=list(res.box.log2),
                           mask=last["mask"].cpu(), x=last["x"].cpu())
        print(f"[ab] {name} solve: box {res.box.shape} nmult "
              f"{res.stats.nmult}, last input "
              f"{float(last['mask'].float().mean()):.4f}"
              f" of the box active, wall {time.perf_counter() - t0:.2f} s",
              flush=True)
    torch.save(saved, out)


def mode_time(tree, inputs):
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from krylovfspssa_tpu_torch.boxspace.box import BoxSpace
    from krylovfspssa_tpu_torch.ops import stencil_cuda as sc

    solves = {name: model for name, model, *_ in _solves()}
    cases = []
    for name, x0, targets in (
            ("goutsias", [[2, 6, 0, 2, 0, 0]], [64, 64, 16, 4, 4, 4]),
            ("toggle", [[0, 0]], [512, 512])):
        box = _grown(solves[name], x0, targets)
        for dt in (torch.float64, torch.float32):
            cases.append((f"dense {name} {box.volume} cells {str(dt)[6:]}",
                          solves[name], box, *_face_inputs(box, dt)))
    for name, d in torch.load(inputs).items():
        model = solves[name]
        box = BoxSpace(n_species=len(d["axis"]),
                       axis_of_species=tuple(d["axis"]),
                       log2=tuple(d["log2"]),
                       stoichiometry=np.asarray(model.stoichiometry,
                                                np.int64))
        cases.append((f"{name} solve's last input, {box.volume} cells "
                      f"float64", model, box, d["mask"].cuda(),
                      d["x"].cuda()))
    rows = {}
    for name, model, box, mask, x in cases:
        pack = sc.pack_stencil(model, box, x.dtype, "cuda")
        y = sc.box_stencil(pack, mask, x)
        ref = sc._box_stencil_plain(pack, mask, x)
        torch.cuda.synchronize()
        rows[name] = dict(
            us=1e3 * _time_ms(sc.box_stencil, pack, mask, x),
            rel_err=float((y - ref).abs().max() / ref.abs().max()),
            active=float(mask.float().mean()))
    print(json.dumps(rows))


def main(argv) -> int:
    import torch

    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_stencil: no CUDA device", file=sys.stderr)
        return 1
    trees = [str(Path(d).resolve()) for d in argv]
    tags = [Path(t).name for t in trees]
    me = str(Path(__file__).resolve())
    builds = [subprocess.Popen([sys.executable, me, "--build", t],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for t in trees]
    for tag, p in zip(tags, builds):
        log = p.communicate()[0]
        print(f"[ab] build {tag}: exit {p.returncode}\n{log}", flush=True)
        if p.returncode:
            return 1
    with tempfile.TemporaryDirectory() as tmp:
        inputs = str(Path(tmp) / "inputs.pt")
        subprocess.run([sys.executable, me, "--capture", trees[0], inputs],
                       check=True)
        runs = {}
        for tag, tree in zip(tags + tags[::-1], trees + trees[::-1]):
            out = subprocess.run([sys.executable, me, "--time", tree, inputs],
                                 capture_output=True, text=True, check=True)
            for case, row in json.loads(out.stdout.splitlines()[-1]).items():
                runs.setdefault(case, {}).setdefault(tag, []).append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[ab] {smi}; us per launch of box_stencil, each checkout's "
          "runs in the order they ran; worst error relative to max|y| of "
          "its plain version")
    for case, by in runs.items():
        print(f"[ab] {case} (active {next(iter(by.values()))[0]['active']:.4f})")
        for tag, rs in by.items():
            print(f"[ab]   {tag:12s} "
                  + " ".join(f"{r['us']:9.2f}" for r in rs)
                  + f"   err {max(r['rel_err'] for r in rs):.2e}")
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/ab_stencil.json").write_text(
        json.dumps(dict(card=smi, runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    modes = {"--build": mode_build, "--capture": mode_capture,
             "--time": mode_time}
    if len(sys.argv) > 1 and sys.argv[1] in modes:
        modes[sys.argv[1]](*sys.argv[2:])
    else:
        sys.exit(main(sys.argv[1:]))
