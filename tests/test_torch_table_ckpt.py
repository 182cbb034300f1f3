"""Table-backend checkpoints and the CLI of the PyTorch port, on the CPU.

A table snapshot (states, w, carry, tolerances, ``rng_state``) has the JAX
package's npz fields, so it crosses between the packages both ways: a
snapshot written mid-solve by either package resumes in the other and
ends within 2 x fsp_tol of the uninterrupted solve (the packages draw
different SSA streams from the snapshot's key).  The port's own mid-solve
resume, in both loops, and ``kfs-torch solve --backend table``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import krylovfspssa_tpu.solver as jsolver
from krylovfspssa_tpu.checkpoint import load_table_checkpoint as j_load
from krylovfspssa_tpu.checkpoint import save_table_checkpoint as j_save
from krylovfspssa_tpu.config import SolverConfig as JConfig
from krylovfspssa_tpu.krylov.stepper import initial_carry as j_initial_carry
from krylovfspssa_tpu.models import library as jlib
from krylovfspssa_tpu_torch import SolverConfig, solve_cme
from krylovfspssa_tpu_torch.checkpoint import (
    load_table_checkpoint,
    save_table_checkpoint,
)
from krylovfspssa_tpu_torch.cli import main as cli_main
from krylovfspssa_tpu_torch.krylov.stepper import carry_from_numpy
from krylovfspssa_tpu_torch.models import library as tlib
from krylovfspssa_tpu_torch.solver import _key_of_seed, _split_key

torch.set_num_threads(2)

KW = dict(fsp_tol=1e-5, krylov_tol=1e-10)
T = 20.0


def _l1(a, b):
    pa = {tuple(s): p for s, p in zip(a.states, a.probabilities)}
    pb = {tuple(s): p for s, p in zip(b.states, b.probabilities)}
    return sum(abs(pa.get(k, 0.0) - pb.get(k, 0.0)) for k in set(pa) | set(pb))


@pytest.fixture(scope="module")
def full():
    """The uninterrupted port solve (bursting_gene t=20, fused)."""
    return solve_cme(tlib.bursting_gene_model(), T, [[0, 0]], device="cpu",
                     **KW)


def test_snapshot_fields_cross_both_ways(tmp_path):
    states = np.array([[0, 0], [1, 0], [0, 3]], np.int32)
    w = np.array([0.5, 0.25, 0.25])
    jc = j_initial_carry(1.0, T, 1e-10, 1.0, 10)
    key = _split_key(_key_of_seed(4))[0]
    save_table_checkpoint(tmp_path / "t.npz", states, w,
                          carry_from_numpy(jc._asdict()), T, 1e-5, 1e-10,
                          key)
    got = j_load(tmp_path / "t.npz")
    np.testing.assert_array_equal(got[0], states)
    np.testing.assert_array_equal(got[1], w)
    assert float(got[2].t_new) == float(jc.t_new)
    assert got[2].nstep.dtype == jnp.int32
    assert got[3:6] == (T, 1e-5, 1e-10)
    # the port's key is a JAX PRNG key: two uint32 words
    assert got[6].dtype == np.uint32 and got[6].shape == (2,)
    j_save(tmp_path / "j.npz", states, w, jc, T, 1e-5, 1e-10,
           np.asarray([0, 7], np.uint32))
    back = load_table_checkpoint(tmp_path / "j.npz")
    np.testing.assert_array_equal(back[0], states)
    assert isinstance(back[2].t_new, np.float64)
    assert back[2].nstep.dtype == np.int32
    np.testing.assert_array_equal(back[6], [0, 7])
    with pytest.raises(ValueError, match="table"):
        from krylovfspssa_tpu_torch.checkpoint import save_checkpoint
        from krylovfspssa_tpu_torch.boxspace.box import BoxSpace

        box = BoxSpace.for_model(np.array([[1, 0]]), [[0, 0]])
        save_checkpoint(tmp_path / "b.npz", box, np.zeros(box.volume, bool),
                        np.zeros(box.volume), back[2], T, 1e-5, 1e-10)
        load_table_checkpoint(tmp_path / "b.npz")


def _keep_snapshots(monkeypatch, module, tmp_path):
    """Keep a copy of every snapshot ``module.save_table_checkpoint``
    writes (the solve overwrites one file); returns their paths."""
    import shutil

    real = module.save_table_checkpoint
    kept = []

    def save(path, *args):
        real(path, *args)
        kept.append(tmp_path / f"snap{len(kept)}.npz")
        shutil.copy(path, kept[-1])

    monkeypatch.setattr(module, "save_table_checkpoint", save)
    return kept


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mid_solve_snapshot_resumes_in_the_other_package(
        tmp_path, full, writer, monkeypatch):
    import krylovfspssa_tpu.checkpoint as jck
    import krylovfspssa_tpu_torch.checkpoint as tck

    ck = str(tmp_path / "ck.npz")
    kept = _keep_snapshots(monkeypatch, tck if writer == "port" else jck,
                           tmp_path)
    if writer == "port":
        solve_cme(tlib.bursting_gene_model(), T, [[0, 0]], device="cpu",
                  checkpoint_path=ck, checkpoint_every=8, **KW)
    else:
        jsolver.solve_cme(jlib.bursting_gene_model(), T, [[0, 0]],
                          checkpoint_path=ck, checkpoint_every=8, **KW)
    snap = kept[0]
    nstep = int(load_table_checkpoint(snap)[2].nstep)
    assert 8 <= nstep < full.stats.nstep
    if writer == "port":
        res = jsolver.solve_cme(jlib.bursting_gene_model(), 0.0, None,
                                resume_from=str(snap), **KW)
    else:
        res = solve_cme(tlib.bursting_gene_model(), 0.0, None,
                        resume_from=str(snap), device="cpu", **KW)
    assert res.stats.iflag == 0 and res.stats.t_final >= T
    assert res.stats.nstep > nstep
    assert _l1(res, full) <= 2 * KW["fsp_tol"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_port_resumes_its_own_snapshot(tmp_path, full, fused, monkeypatch):
    import krylovfspssa_tpu_torch.checkpoint as tck

    ck = str(tmp_path / "ck.npz")
    kept = _keep_snapshots(monkeypatch, tck, tmp_path)
    cfg = SolverConfig(fused_steps=fused)
    ran = solve_cme(tlib.bursting_gene_model(), T, [[0, 0]], device="cpu",
                    config=cfg, checkpoint_path=ck, checkpoint_every=6,
                    **KW)
    snap = kept[0]
    states, _, carry, t_ck, *_, key = load_table_checkpoint(snap)
    assert 0 < float(carry.t_now) < T and t_ck == T
    res = solve_cme(tlib.bursting_gene_model(), 0.0, None, device="cpu",
                    config=cfg, resume_from=str(snap), **KW)
    assert res.stats.iflag == 0 and res.stats.t_final >= T
    assert res.stats.nstep > int(carry.nstep)
    assert _l1(res, ran) <= 2 * KW["fsp_tol"]
    assert _l1(res, full) <= 2 * KW["fsp_tol"]
    # the snapshot holds the solver's key chain after its expansions
    assert not np.array_equal(key, _key_of_seed(0))


def test_cli_solve_table(tmp_path, capsys):
    out = tmp_path / "r.npz"
    rc = cli_main(["solve", "bursting_gene", "--t", "5", "--fsp-tol", "1e-5",
                   "--backend", "table", "--table-operator", "ell",
                   "--device", "cpu", "--json", "-o", str(out)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["backend"] == "table" and rec["t"] >= 5.0
    assert rec["wsum"] >= 1 - 1e-5 and rec["nstep"] >= 1
    with np.load(out) as z:
        assert z["states"].shape[0] == rec["fsp_size"]
    assert any(line.startswith("backend        : table (cpu)")
               for line in lines)
    # the pencil operator and the row-sharded table (gloo ranks) solve
    # the same model within fsp_tol of the ELL run
    for extra in (["--table-operator", "pencil"], ["--devices", "2"]):
        assert cli_main(["solve", "bursting_gene", "--t", "5", "--fsp-tol",
                         "1e-5", "--backend", "table", "--device", "cpu",
                         "--json", *extra]) == 0
        other = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert other["t"] >= 5.0
        assert abs(other["wsum"] - rec["wsum"]) <= 1e-5
