"""The port imports torch and numpy and never JAX: a fresh interpreter
imports every module of the package (the sharded solve's ``parallel.*``
and ``ops.halo`` by name), runs a small toggle solve on the CPU, once on
one device and once on a mesh of one rank, and the CLI entry point, and
finds no ``jax`` (nor the JAX package) in ``sys.modules``."""

import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

_CHILD = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(2)
import krylovfspssa_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
import krylovfspssa_tpu_torch.ops.halo
import krylovfspssa_tpu_torch.parallel.dryrun
import krylovfspssa_tpu_torch.parallel.multihost
from krylovfspssa_tpu_torch.parallel import ShardMesh, make_mesh
from krylovfspssa_tpu_torch import solve_cme_box
from krylovfspssa_tpu_torch.cli import main
from krylovfspssa_tpu_torch.models.library import toggle_file_model
r = solve_cme_box(toggle_file_model(), 1.0, [[0, 0]], fsp_tol=1e-4,
                  krylov_tol=1e-8, device="cpu")
assert r.stats.iflag == 0 and r.wsum >= 1 - 1e-4, r.wsum
rm = solve_cme_box(toggle_file_model(), 1.0, [[0, 0]], fsp_tol=1e-4,
                   krylov_tol=1e-8, mesh=make_mesh("cpu"))
assert isinstance(make_mesh("cpu"), ShardMesh)
assert rm.stats.iflag == 0 and rm.box.shape == r.box.shape, rm.wsum
assert main(["info", "goutsias"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "krylovfspssa_tpu.")))
assert not bad, bad
print("MODULES", len(mods))
"""


def test_port_runs_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split("MODULES")[1]) >= 19


def test_no_jax_import_in_port_sources():
    banned = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|krylovfspssa_tpu)(\.|\s|$)", re.M
    )
    paths = [*(ROOT / "krylovfspssa_tpu_torch").rglob("*.py"),
             ROOT / "chip_smoke.py", ROOT / "ab_stencil.py"]
    for path in paths:
        assert not banned.search(path.read_text()), path
