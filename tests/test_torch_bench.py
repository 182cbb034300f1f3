"""``kfs-torch bench`` (krylovfspssa_tpu_torch/bench.py) on the CPU: the same
Goutsias box as the JAX package's root ``bench.py``, one JSON line on
stdout whose value is the logged time's CSR roofline share, the memory
rate by card name, and the zero line on failure."""

import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from krylovfspssa_tpu_torch import bench
from krylovfspssa_tpu_torch.cli import main

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scale", [8, 16, 64])
def test_build_box_matches_the_jax_bench(scale):
    jmodel, jbox = _root_bench().build_box(target_m=scale, target_d=scale)
    model, box = bench.build_box(scale)
    assert tuple(box.shape) == tuple(jbox.shape)
    assert box.volume == jbox.volume
    np.testing.assert_array_equal(np.asarray(box.offsets),
                                  np.asarray(jbox.offsets))
    assert model.n_reactions == jmodel.n_reactions
    if scale == 64:
        assert box.volume == 4_194_304


def test_cpu_run_prints_one_line(monkeypatch, capsys):
    # 2 chained matvecs, not 400: the plain versions take milliseconds each
    monkeypatch.setattr(bench, "ITERS", 2)
    monkeypatch.setattr(bench, "REPEATS", 1)
    assert main(["bench", "--device", "cpu", "--scale", "8",
                 "--ignore-load"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["metric"] == "spmv_csr_roofline_pct" and rec["unit"] == "%"
    model, box = bench.build_box(8)
    vol, nnz = box.volume, box.volume * (model.n_reactions + 1)
    pcts = {}
    for name in ("box_stencil-f64", "box_stencil-f32", "direct_stencil-f64",
                 "direct_stencil-f32"):
        m = re.search(rf"^{name}: .*\(per (\S+) s\).* launches (\d+)$", err,
                      re.M)
        assert m, (name, err)
        vb = 8 if name.endswith("f64") else 4
        csr_roof = (nnz * (4 + vb) + vol * 3 * vb) / bench.CPU_BYTES_PER_S
        pcts[name] = 100.0 * csr_roof / float(m.group(1))
        # the plain versions launch no kernel
        assert int(m.group(2)) == 0
    assert rec["value"] == max(pcts.values())
    assert rec["vs_baseline"] == rec["value"] / 70.0


def test_memory_rate_by_card_name(monkeypatch):
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert bench.memory_rate(cuda) == 3.35e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "Some Other GPU")
    with pytest.raises(ValueError, match="hbm-bytes-per-s"):
        bench.memory_rate(cuda)
    assert bench.memory_rate(cuda, 1.5e12) == 1.5e12
    assert bench.memory_rate(torch.device("cpu")) == 100e9


def test_failure_prints_zero_line_and_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["bench", "--scale", "8", "--ignore-load"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == {
        "metric": "spmv_csr_roofline_pct", "value": 0.0, "unit": "%",
        "vs_baseline": 0.0}


def test_bench_is_a_subcommand(capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    assert "bench" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["bench", "--help"])
    text = capsys.readouterr().out
    assert "--scale" in text and "--hbm-bytes-per-s" in text
