"""The port imports torch and numpy and never JAX: a fresh interpreter
imports every module of the package (the sharded solve's ``parallel.*``,
``ops.halo`` and the fused loop's ``krylov.advance`` by name), runs a small
toggle solve on the CPU -- in the fused loop (the default) on one device,
with segments of 3 steps, and on a mesh of one rank, and in the stepwise
loop -- and the CLI entry point, and finds no ``jax`` (nor the JAX
package) in ``sys.modules``."""

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
assert "krylovfspssa_tpu_torch.bench" in mods
import krylovfspssa_tpu_torch.ops.halo
from krylovfspssa_tpu_torch.krylov.advance import RECORD_FIELDS, make_advance_fn
import krylovfspssa_tpu_torch.parallel.dryrun
import krylovfspssa_tpu_torch.parallel.multihost
from krylovfspssa_tpu_torch.parallel import ShardMesh, make_mesh
from krylovfspssa_tpu_torch import BoxCmeSolver, SolverConfig, solve_cme_box
from krylovfspssa_tpu_torch.cli import main
from krylovfspssa_tpu_torch.models.library import toggle_file_model
r = solve_cme_box(toggle_file_model(), 1.0, [[0, 0]], fsp_tol=1e-4,
                  krylov_tol=1e-8, device="cpu")
assert r.stats.iflag == 0 and r.wsum >= 1 - 1e-4, r.wsum
seg = BoxCmeSolver(toggle_file_model(), SolverConfig(max_steps_per_call=3),
                   device="cpu")
rs = seg.solve(1.0, [[0, 0]], fsp_tol=1e-4, krylov_tol=1e-8)
assert any(k[0] == "adv" and k[-1] == 3 for k in seg._fns)
assert rs.stats.iflag == 0 and rs.wsum >= 1 - 1e-4, rs.wsum
rw = solve_cme_box(toggle_file_model(), 1.0, [[0, 0]], fsp_tol=1e-4,
                   krylov_tol=1e-8, config=SolverConfig(fused_steps=False),
                   device="cpu")
assert rw.stats.nstep == r.stats.nstep and len(RECORD_FIELDS) == 11
rm = solve_cme_box(toggle_file_model(), 1.0, [[0, 0]], fsp_tol=1e-4,
                   krylov_tol=1e-8, mesh=make_mesh("cpu"))
assert isinstance(make_mesh("cpu"), ShardMesh)
assert rm.stats.iflag == 0 and rm.box.shape == r.box.shape, rm.wsum
assert main(["info", "goutsias"]) == 0
import krylovfspssa_tpu_torch.native
from krylovfspssa_tpu_torch import CmeSolver, SolveResult, solve_cme
from krylovfspssa_tpu_torch.krylov.advance import make_table_advance_fn
from krylovfspssa_tpu_torch.ops.spmv import spmv
from krylovfspssa_tpu_torch.statespace import StateEncoder, StateTable
for fused in (True, False):
    rt = solve_cme(toggle_file_model(), 1.0, [[0, 0]], fsp_tol=1e-4,
                   krylov_tol=1e-8, config=SolverConfig(fused_steps=fused),
                   device="cpu")
    assert isinstance(rt, SolveResult) and rt.stats.iflag == 0, rt.wsum
    assert rt.table.host_index is not None and rt.wsum >= 1 - 1e-4
from krylovfspssa_tpu_torch.ops.pencil import PencilOperator, pencil_matvec
from krylovfspssa_tpu_torch.parallel import sharded_matvec, sharded_step_fn
rp = solve_cme(toggle_file_model(), 1.0, [[0, 0]], fsp_tol=1e-4,
               krylov_tol=1e-8, config=SolverConfig(table_operator="pencil"),
               device="cpu")
assert rp.stats.iflag == 0 and abs(rp.wsum - rt.wsum) < 1e-6, rp.wsum
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
             ROOT / "chip_smoke.py", ROOT / "ab_stencil.py",
             ROOT / "ab_expm.py"]
    for path in paths:
        assert not banned.search(path.read_text()), path
