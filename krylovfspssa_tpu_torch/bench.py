"""``kfs-torch bench``: the CME SpMV against the stored-CSR memory roofline
(the port's counterpart of the JAX package's ``kfs bench``).

    kfs-torch bench [--scale 64] [--device cuda] [--hbm-bytes-per-s R]
    python -m krylovfspssa_tpu_torch.bench ...

Prints ONE JSON line on stdout:

  {"metric": "spmv_csr_roofline_pct", "value": <pct>, "unit": "%",
   "vs_baseline": <pct/70>}

and one line per variant on stderr.  The operator is the solver's hottest
op, the projected CME generator matvec, on the Goutsias box grown to
(scale, scale, 16, 4, 4, 4): 4,194,304 cells at the default scale of 64,
all of them active.  Each variant is one of the port's hand-written
kernels, built through its normal matvec builder
(``ops/stencil_cuda.py``): ``box_stencil`` (the separable mode, the main
path's kernel) and ``direct_stencil`` (the direct mode, for models that do
not factor), each in float64 and float32.  On the CPU (``--device cpu``,
for tests) each wrapper takes its plain PyTorch version.

A variant runs 400 chained matvecs, each followed by a normalisation in
the vector's dtype, timed on the device (CUDA events) and kept as the best
of 2 repeats, each repeat on a distinct input.  The roofline is the time a
perfect stored-CSR SpMV of the same operator would need to move its bytes
at the device's memory rate: (4-byte column index + value) per nonzero,
nnz = cells x (reactions + 1), plus three vectors.  The stencil reads only
x, y and the mask, so 100% is not its ceiling; the matrix-free roofline
(x and y in the dtype, one mask byte per cell) is printed on stderr.  The
headline is the fastest variant's percentage, and vs_baseline is it over
70.  The number is this card's and this port's: it is not comparable to
the JAX package's TPU figure, which has another memory rate and kernel.

The memory rate comes from a table keyed by the card's name
(``torch.cuda.get_device_name()``); another card raises unless
``--hbm-bytes-per-s`` gives its rate.  On failure the line above is
printed with value 0 and the error is raised again (a non-zero exit).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

#: device memory rate in bytes/s by ``torch.cuda.get_device_name()``
HBM_BYTES_PER_S = {
    # H100 SXM5: 3.35 TB/s (NVIDIA H100 Tensor Core GPU data sheet)
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
#: the rate the CPU's plain versions are held to (the JAX package's
#: ``bench.py`` uses the same figure for its CPU run)
CPU_BYTES_PER_S = 100e9
#: BASELINE.md's target for the CSR roofline share
BASELINE_PCT = 70.0
#: chained matvecs per timed run, and timed runs per variant (the best
#: kept)
ITERS = 400
REPEATS = 2

#: the Goutsias start state and the species extents the box is grown to
#: (the first two are ``scale``)
X0 = [[2, 6, 0, 2, 0, 0]]
EXTENTS = (16, 4, 4, 4)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def memory_rate(device, override: float | None = None) -> float:
    """The memory rate (bytes/s) of ``device``: ``override`` if given,
    :data:`CPU_BYTES_PER_S` on the CPU, else the table's entry for the
    card's name (an unknown card raises)."""
    import torch

    if override is not None:
        return float(override)
    device = torch.device(device)
    if device.type == "cpu":
        return CPU_BYTES_PER_S
    name = torch.cuda.get_device_name(device)
    if name not in HBM_BYTES_PER_S:
        raise ValueError(
            f"no memory rate for {name!r} (known: {sorted(HBM_BYTES_PER_S)})"
            "; pass --hbm-bytes-per-s")
    return HBM_BYTES_PER_S[name]


def build_box(scale: int = 64):
    """(model, box): the Goutsias model and its box grown from ``X0`` to
    the extents (scale, scale, 16, 4, 4, 4)."""
    from .boxspace.box import BoxSpace
    from .models.library import goutsias_model

    model = goutsias_model()
    box = BoxSpace.for_model(model.stoichiometry, X0)
    for s, target in enumerate((scale, scale, *EXTENTS)):
        while box.extents[s] < target:
            box = box.grow(s)
    return model, box


def time_matvec(matvec, mask, x, iters: int, repeats: int) -> float:
    """Seconds per matvec: the best of ``repeats`` chains of ``iters``
    matvecs, each followed by a normalisation in x's dtype (so that the
    chain neither overflows nor vanishes), after one warm-up chain.  Every
    chain starts from a distinct input.  On a card the chain is timed by
    CUDA events around it; on the CPU by the host clock."""
    import torch

    eps = torch.tensor(1e-30, dtype=x.dtype, device=x.device)

    def chain(v):
        for _ in range(iters):
            y = matvec(mask, v)
            v = y / torch.sqrt(torch.sum(y * y) + eps)
        return v

    rng = np.random.default_rng(123)
    xs = [x * (1.0 + 1e-3 * rng.random()) for _ in range(repeats + 1)]
    cuda = x.device.type == "cuda"
    chain(xs[0])
    if cuda:
        torch.cuda.synchronize(x.device)
    best = np.inf
    for v in xs[1:]:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(v)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            chain(v)
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best / iters


def host_quiet_guard(ignore: bool = False) -> None:
    """Wait (up to 10 min) while the host's 1-minute load is above 1.5x its
    CPU count: the chained loop needs a responsive host to enqueue its
    launches, and contention inflates the readings.  ``ignore`` (the
    ``--ignore-load`` flag) measures anyway."""
    if ignore:
        return
    try:
        load1 = os.getloadavg()[0]
        ncpu = os.cpu_count() or 1
    except OSError:
        return
    if load1 <= 1.5 * ncpu:
        return
    log(f"host busy (load {load1:.1f} on {ncpu} CPUs): the readings would "
        "be inflated by contention; waiting up to 10 min for quiet "
        "(--ignore-load measures anyway)")
    deadline = time.time() + 600
    while time.time() < deadline:
        time.sleep(20)
        load1 = os.getloadavg()[0]
        if load1 <= ncpu:
            log(f"host quiet (load {load1:.1f}); proceeding")
            return
    log(f"host still busy (load {load1:.1f}) after 10 min: proceeding, but "
        "the readings are contention-flagged")


def _launches(kernel: str) -> int:
    from .ops import stencil_cuda

    return (stencil_cuda.LAUNCHES if kernel == "box_stencil"
            else stencil_cuda.DIRECT_LAUNCHES)


def variants(model, box, device):
    """(name, kernel, dtype, matvec) of each variant, through the kernels'
    matvec builders on ``device``."""
    import torch

    from .ops import stencil_cuda

    out = []
    for kernel, make in (
            ("box_stencil", stencil_cuda.make_box_stencil_matvec),
            ("direct_stencil", stencil_cuda.make_direct_stencil_matvec)):
        for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
            out.append((f"{kernel}-{tag}", kernel, dtype,
                        make(model, box, dtype, device)))
    return out


def run(args) -> int:
    t_start = time.time()
    host_quiet_guard(args.ignore_load)
    try:
        import torch

        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (--device cpu runs the plain "
                               "versions)")
        bw = memory_rate(device, args.hbm_bytes_per_s)
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        log(f"device {name}: memory rate {bw:.4g} B/s")

        model, box = build_box(args.scale)
        vol, R = box.volume, model.n_reactions
        nnz = vol * (R + 1)
        log(f"box {box.shape} vol={vol} nnz={nnz} "
            f"maxoff={int(np.abs(box.offsets).max())}")

        mask = torch.ones(vol, dtype=torch.bool, device=device)
        x0 = np.random.default_rng(0).random(vol)
        results = {}
        for vname, kernel, dtype, matvec in variants(model, box, device):
            vb = torch.empty((), dtype=dtype).element_size()
            x = torch.as_tensor(x0, dtype=dtype, device=device)
            before = _launches(kernel)
            per = time_matvec(matvec, mask, x, ITERS, REPEATS)
            launches = _launches(kernel) - before
            csr_roof = (nnz * (4 + vb) + vol * 3 * vb) / bw
            mf_roof = vol * (2 * vb + 1) / bw
            pct = 100.0 * csr_roof / per
            results[vname] = pct
            log(f"{vname}: {per * 1e6:.3f} us/matvec (per {per!r} s), "
                f"{nnz / per / 1e9:.3f} Gnnz/s, CSR roofline "
                f"{csr_roof * 1e6:.3f} us -> {pct:.2f}% (matrix-free "
                f"roofline {mf_roof * 1e6:.3f} us -> "
                f"{100.0 * mf_roof / per:.2f}%), launches {launches}")

        log(f"total bench wall: {time.time() - t_start:.1f}s")
        # headline: the fastest variant against its dtype's CSR roofline
        pct = max(results.values())
        print(json.dumps({"metric": "spmv_csr_roofline_pct", "value": pct,
                          "unit": "%", "vs_baseline": pct / BASELINE_PCT}),
              flush=True)
        return 0
    except Exception as e:  # noqa: BLE001 - printed, then raised again
        log(f"bench failed: {type(e).__name__}: {e}")
        print(json.dumps({"metric": "spmv_csr_roofline_pct", "value": 0.0,
                          "unit": "%", "vs_baseline": 0.0}), flush=True)
        raise


def add_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scale", type=int, default=64,
                   help="extent of the Goutsias box's first two species "
                   "(default 64: 4,194,304 cells)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu times the plain "
                   "versions against 100e9 B/s)")
    p.add_argument("--hbm-bytes-per-s", type=float,
                   help="the device's memory rate in bytes/s (required for "
                   "a card not in the table)")
    p.add_argument("--ignore-load", action="store_true",
                   help="measure even if the host is busy")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kfs-torch bench",
                                description=__doc__.split("\n\n")[0])
    add_arguments(p)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
