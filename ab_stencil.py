#!/usr/bin/env python3
"""A/B timing of the stencil kernels (``box_stencil``, ``direct_stencil``)
of several checkouts of the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 ab_stencil.py [--kernel box|direct|both] DIR [DIR ...]

Each DIR holds a ``krylovfspssa_tpu_torch`` package (a checkout, or a
``git archive`` of another commit unpacked into a directory that
``.gitignore`` lists, such as ``build/``).  The script builds every
checkout's kernels at once (one nvcc each), then, with the first DIR, runs
solves on the card and keeps the last input (mask, x) each gave its kernel
(the kernel's inputs on that solve path):

  * ``box_stencil``: the Goutsias t=10 solve (fsp_tol 1e-6, krylov_tol
    1e-8) and the toggle t=1000 solve (fsp_tol 1e-4, krylov_tol 1e-10);
  * ``direct_stencil``: the CUSTOMPROP toggle t=100 solve
    (``toggle_programmatic``, fsp_tol 1e-4, krylov_tol 1e-10) and the ge5d
    t=1 solve (library callable, fsp_tol 1e-4, krylov_tol 1e-8,
    box_min_log2 2).

Then each DIR, in its own process, in the order A B .. B A, times each
kernel (20 back-to-back launches between two CUDA events behind
``torch.cuda._sleep``, median of 5) on

  * ``box_stencil``: the 2^22-cell Goutsias box and a 512x512 toggle box;
  * ``direct_stencil``: the box the ge5d solve ended in (2^23 cells), the
    2^22-cell Goutsias box sent through the direct form and a 512x512
    ``toggle_programmatic`` box;

each with 60% of the cells active and every face of the box on, float64
and float32, and on the solves' last inputs in float64.  Each case is
checked against the checkout's own plain version; a direct case also
times the checkout's operand build (host clock, synchronised; peak device
memory above the inputs) and one CSR SpMV of the masked generator
(``torch.sparse_csr_tensor @ x``, the library yardstick, built from the
propensity fields).  y is hashed (with -0 taken as 0), so the lines show
whether the checkouts compute the same bits.  It prints one line per case
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


#: kernel -> the solves whose last input it is timed on: (name, model
#: factory, t, x0, fsp_tol, krylov_tol), default SolverConfig
SOLVES = {
    "box_stencil": (
        ("goutsias", "goutsias_model", 10.0, [[2, 6, 0, 2, 0, 0]], 1e-6,
         1e-8),
        ("toggle", "toggle_file_model", 1000.0, [[0, 0]], 1e-4, 1e-10)),
    "direct_stencil": (
        ("customprop", "toggle_programmatic_model", 100.0, [[0, 0]], 1e-4,
         1e-10),
        ("ge5d", "ge5d_model", 1.0, [[0, 0, 0, 0, 0]], 1e-4, 1e-8)),
}
KERNELS = {"box": ["box_stencil"], "direct": ["direct_stencil"],
           "both": ["box_stencil", "direct_stencil"]}


def _model(factory):
    from krylovfspssa_tpu_torch.models import library

    return getattr(library, factory)()


def mode_build(tree):
    sys.path.insert(0, tree)
    from krylovfspssa_tpu_torch.ops import stencil_cuda as sc

    info = sc.build()
    print("\n".join(ln.strip() for ln in info.log.splitlines()
                    if "registers" in ln or "Compiling entry" in ln))


def mode_capture(tree, out, kernels):
    sys.path.insert(0, tree)
    import torch

    from krylovfspssa_tpu_torch import BoxCmeSolver
    from krylovfspssa_tpu_torch.ops import stencil_cuda as sc

    saved = {}
    for kname in kernels.split(","):
        last = {}
        kernel = getattr(sc, kname)

        def keep_last(pack, mask, x, kernel=kernel, last=last):
            last["mask"], last["x"] = mask.clone(), x.clone()
            return kernel(pack, mask, x)

        setattr(sc, kname, keep_last)
        for name, factory, t, x0, fsp_tol, krylov_tol in SOLVES[kname]:
            t0 = time.perf_counter()
            res = BoxCmeSolver(_model(factory), device="cuda").solve(
                t, x0, fsp_tol=fsp_tol, krylov_tol=krylov_tol)
            torch.cuda.synchronize()
            saved[name] = dict(kernel=kname, factory=factory,
                               axis=list(res.box.axis_of_species),
                               log2=list(res.box.log2),
                               mask=last["mask"].cpu(), x=last["x"].cpu())
            print(f"[ab] {name} solve: box {res.box.shape} nmult "
                  f"{res.stats.nmult}, last input "
                  f"{float(last['mask'].float().mean()):.4f}"
                  f" of the box active, wall {time.perf_counter() - t0:.2f} "
                  "s", flush=True)
        setattr(sc, kname, kernel)
    torch.save(saved, out)


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


def _direct_csr(model, box, mask, dt):
    """The masked direct-form generator as a CSR matrix, from the
    propensity fields and the box validity (ops/stencil.py, the same in
    every checkout)."""
    import torch

    from krylovfspssa_tpu_torch.ops.stencil import (
        _dest_valid,
        propensity_fields,
    )

    vol = box.volume
    fields = propensity_fields(model, box, dt, "cuda")
    i = torch.nonzero(mask).squeeze(1)
    rows, cols, vals = [i], [i], [-sum(fields)[i]]
    for k, off in enumerate(int(o) for o in box.offsets):
        j = (i - off).clamp(0, vol - 1)
        a = fields[k][j]
        keep = _dest_valid(box, i, k) & mask[j] & (a != 0)
        rows.append(i[keep])
        cols.append(j[keep])
        vals.append(a[keep])
    del fields
    return _csr(rows, cols, vals, (vol, vol))


def _digest(y):
    import hashlib

    return hashlib.sha1((y + 0.0).cpu().numpy().tobytes()).hexdigest()[:12]


def _box_of(d):
    import numpy as np

    from krylovfspssa_tpu_torch.boxspace.box import BoxSpace

    model = _model(d["factory"])
    return model, BoxSpace(n_species=len(d["axis"]),
                           axis_of_species=tuple(d["axis"]),
                           log2=tuple(d["log2"]),
                           stoichiometry=np.asarray(model.stoichiometry,
                                                    np.int64))


def _time_box(solves):
    import torch

    from krylovfspssa_tpu_torch.ops import stencil_cuda as sc

    cases = []
    for factory, x0, targets in (
            ("goutsias_model", [[2, 6, 0, 2, 0, 0]], [64, 64, 16, 4, 4, 4]),
            ("toggle_file_model", [[0, 0]], [512, 512])):
        model = _model(factory)
        box = _grown(model, x0, targets)
        for dt in (torch.float64, torch.float32):
            cases.append((f"box_stencil dense {factory[:-6]} {box.volume} "
                          f"cells {str(dt)[6:]}", model, box,
                          *_face_inputs(box, dt)))
    for name, d in solves.items():
        if d["kernel"] == "box_stencil":
            model, box = _box_of(d)
            cases.append((f"box_stencil {name} solve's last input, "
                          f"{box.volume} cells float64", model, box,
                          d["mask"].cuda(), d["x"].cuda()))
    rows = {}
    for name, model, box, mask, x in cases:
        pack = sc.pack_stencil(model, box, x.dtype, "cuda")
        y = sc.box_stencil(pack, mask, x)
        ref = sc._box_stencil_plain(pack, mask, x)
        torch.cuda.synchronize()
        rows[name] = dict(
            us=1e3 * _time_ms(sc.box_stencil, pack, mask, x),
            rel_err=float((y - ref).abs().max() / ref.abs().max()),
            active=float(mask.float().mean()), y=_digest(y))
    return rows


def _time_direct(solves):
    import torch

    from krylovfspssa_tpu_torch.ops import stencil_cuda as sc

    ge5d = next(d for d in solves.values() if d["factory"] == "ge5d_model")
    cases = []
    for factory, box in (
            ("ge5d_model", _box_of(ge5d)[1]),
            ("goutsias_model", _grown(_model("goutsias_model"),
                                      [[2, 6, 0, 2, 0, 0]],
                                      [64, 64, 16, 4, 4, 4])),
            ("toggle_programmatic_model",
             _grown(_model("toggle_programmatic_model"), [[0, 0]],
                    [512, 512]))):
        for dt in (torch.float64, torch.float32):
            cases.append((f"direct_stencil dense {factory[:-6]} "
                          f"{box.volume} cells {str(dt)[6:]}",
                          _model(factory), box, *_face_inputs(box, dt)))
    for name, d in solves.items():
        if d["kernel"] == "direct_stencil":
            model, box = _box_of(d)
            cases.append((f"direct_stencil {name} solve's last input, "
                          f"{box.volume} cells float64", model, box,
                          d["mask"].cuda(), d["x"].cuda()))
    rows = {}
    for name, model, box, mask, x in cases:
        # a first build loads the evaluator's kernels: time the second
        sc.pack_direct_stencil(model, box, x.dtype, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        pack = sc.pack_direct_stencil(model, box, x.dtype, "cuda")
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        build_mib = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        y = sc.direct_stencil(pack, mask, x)
        ref = sc._direct_stencil_plain(pack, mask, x)
        torch.cuda.synchronize()
        us = 1e3 * _time_ms(sc.direct_stencil, pack, mask, x)
        del pack
        csr = _direct_csr(model, box, mask, x.dtype)
        y_csr = csr @ x
        scale = float(ref.abs().max())
        rows[name] = dict(
            us=us, rel_err=float((y - ref).abs().max()) / scale,
            active=float(mask.float().mean()), y=_digest(y),
            build_ms=build_ms, build_mib=build_mib,
            csr_us=1e3 * _time_ms(torch.matmul, csr, x),
            csr_rel_err=float((y_csr - y).abs().max()) / scale)
        del csr
    return rows


def mode_time(tree, inputs, kernels):
    sys.path.insert(0, tree)
    import torch

    solves = torch.load(inputs)
    rows = {}
    for kname in kernels.split(","):
        rows.update((_time_box if kname == "box_stencil"
                     else _time_direct)(solves))
    print(json.dumps(rows))


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="both")
    ap.add_argument("trees", nargs="+", metavar="DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_stencil: no CUDA device", file=sys.stderr)
        return 1
    kernels = ",".join(KERNELS[args.kernel])
    trees = [str(Path(d).resolve()) for d in args.trees]
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
        subprocess.run([sys.executable, me, "--capture", trees[0], inputs,
                        kernels], check=True)
        runs = {}
        for tag, tree in zip(tags + tags[::-1], trees + trees[::-1]):
            out = subprocess.run([sys.executable, me, "--time", tree, inputs,
                                  kernels],
                                 capture_output=True, text=True)
            if out.returncode:
                print(f"[ab] {tag}: exit {out.returncode}\n{out.stderr}")
                return 1
            for case, row in json.loads(out.stdout.splitlines()[-1]).items():
                runs.setdefault(case, {}).setdefault(tag, []).append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[ab] {smi}; us per launch, each checkout's runs in the order "
          "they ran; worst error relative to max|y| of its plain version; "
          "digest of y; for direct_stencil the operand build (ms, MiB of "
          "device memory above the inputs) and the CSR SpMV (us)")
    for case, by in runs.items():
        digests = {r["y"] for rs in by.values() for r in rs}
        print(f"[ab] {case} (active {next(iter(by.values()))[0]['active']:.4f}"
              f"; {'same y in every checkout' if len(digests) == 1 else 'y differs between checkouts'})")
        for tag, rs in by.items():
            extra = ""
            if "csr_us" in rs[0]:
                extra = ("   build " + " ".join(f"{r['build_ms']:.1f}"
                                                for r in rs)
                         + f" ms {max(r['build_mib'] for r in rs):.0f} MiB"
                         + "   csr " + " ".join(f"{r['csr_us']:.2f}"
                                               for r in rs))
            print(f"[ab]   {tag:12s} "
                  + " ".join(f"{r['us']:9.2f}" for r in rs)
                  + f"   err {max(r['rel_err'] for r in rs):.2e}"
                  + f"   y {rs[0]['y']}" + extra)
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
