"""Process groups for the row-sharded solve (PyTorch port of
``krylovfspssa_tpu/parallel/multihost.py``).

The JAX package drives a mesh of devices from one controller per host;
this port runs one process per rank (parallel/sharded.py).  This module
starts those processes and joins them into a group:

  * :func:`initialize` — ``dist.init_process_group`` from the variables
    ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``); a no-op without them;
  * :func:`global_mesh` — the mesh over every rank of the group;
  * :func:`host_gather` — a full numpy copy of a row-sharded tensor on
    every rank;
  * :func:`spawn` — N ranks of one host as fresh processes, joined through
    a FileStore in a temporary directory (``kfs-torch solve --devices N``,
    the tests, ``chip_smoke.py``).

Launch across hosts (one process per card)::

    torchrun --nnodes 2 --nproc-per-node 4 --rdzv-endpoint host0:29500 \\
        -m krylovfspssa_tpu_torch.cli solve goutsias --multihost

    # or, in a program started by torchrun:
    from krylovfspssa_tpu_torch.parallel import multihost
    multihost.initialize()
    mesh = multihost.global_mesh()          # this rank's card
    result = solve_cme_box(model, t, x0, mesh=mesh)   # every rank calls it

    # on the CPU (gloo ranks), name it:
    mesh = multihost.global_mesh("cpu")
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .sharded import DEFAULT_TIMEOUT, ShardMesh

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(init_method: str | None = None,
               backend: str | None = None) -> bool:
    """Join this process to the default process group (idempotent).

    ``init_method`` defaults to ``env://``, which reads torchrun's
    variables; with none of them set and no ``init_method`` this is a
    single-process run and nothing is initialised.  ``backend`` defaults to
    NCCL when CUDA is available (each process then takes the card
    ``LOCAL_RANK``), else gloo.  A configured launch that fails raises: it
    must not silently run as one process.  Returns True if more than one
    process is in the group afterwards.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and not all(v in os.environ
                                       for v in _TORCHRUN_VARS):
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {}
    if backend == "nccl":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method or "env://",
                            timeout=DEFAULT_TIMEOUT, **kw)
    return dist.get_world_size() > 1


def global_mesh(device="cuda") -> ShardMesh:
    """The 1-D mesh over every rank of the default group on this rank's
    ``device`` (its current card unless the CPU is named; raises where
    CUDA is not available); a mesh of one rank when no group was
    initialised."""
    from .sharded import make_mesh

    return make_mesh(device)


def host_gather(t: torch.Tensor, mesh: ShardMesh | None = None) -> np.ndarray:
    """Full numpy copy of a flat tensor on every rank (``t`` is this rank's
    rows under a mesh)."""
    if mesh is not None:
        t = mesh.gather(t)
    return t.cpu().numpy()


# ------------------------------------------------------------- spawning --


def _rank_main(fn, rank, devices, backend, store_path, threads, args,
               results):
    """Body of one spawned rank: join the group, run fn(mesh, *args), send
    (rank, ok, value or traceback) to the parent."""
    try:
        torch.set_num_threads(threads)
        dev = torch.device(devices[rank])
        kw = {}
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            if backend == "nccl":
                kw["device_id"] = dev
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, len(devices)),
            rank=rank, world_size=len(devices),
            timeout=DEFAULT_TIMEOUT, **kw,
        )
        try:
            out = fn(ShardMesh(dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # report every failure, interrupts included
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, devices, args=(), backend="gloo", timeout_s=None,
          threads=None) -> list:
    """Run ``fn(mesh, *args)`` on ``len(devices)`` ranks of this host and
    return their results in rank order.

    Rank r runs on ``devices[r]`` in a fresh interpreter (``spawn``); the
    ranks join one group of ``backend`` through a FileStore in a temporary
    directory.  The caller chooses the backend: NCCL needs one card per
    rank; gloo takes the CPU, or several ranks on one card.  ``fn`` and
    ``args`` must pickle (``fn`` a module-level function) and so must each
    rank's result.  Each rank runs ``threads`` intra-op threads (default:
    this process's share out over the ranks; ranks that each take every
    core slow each other's host dispatch).

    A rank that raises fails the call with its traceback at once (the
    other ranks are stopped); so does ``timeout_s`` seconds passing (no
    limit when None) and a rank that dies without a word.  No rank
    outlives the call.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    threads = threads or max(1, torch.get_num_threads() // len(devices))
    tmp = tempfile.mkdtemp(prefix="kfs_ranks_")
    results = ctx.Queue()
    procs = [
        ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, r, list(map(str, devices)), backend,
                  os.path.join(tmp, "store"), threads, tuple(args), results),
        )
        for r in range(len(devices))
    ]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < len(procs):
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()]
                if dead:
                    # a last message may still be in flight
                    try:
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} died (exit code "
                            f"{procs[dead[0]].exitcode}) without a result"
                        ) from None
                elif deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{len(procs) - len(out)} of {len(procs)} ranks "
                        f"still running after {timeout_s} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(len(procs))]
