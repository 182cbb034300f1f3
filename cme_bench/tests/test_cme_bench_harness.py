"""CPU tests of the benchmark harness: its files, names, draws and
arithmetic, and that it never runs without a card.

    python -m pytest cme_bench/tests -q
"""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cme_bench import devtrace, harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cme_bench"]
    assert BENCH["command"] == ["python3", "cme_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=CELLS)
def test_workload_names_existing_files(w):
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert w["config"] in configs
    assert (ROOT / configs[w["config"]]["file"]).is_file()
    assert (ROOT / "cme_bench" / "reference" / f"{w['config']}.py").is_file()
    assert (ROOT / "cme_bench" / "traffic" / f"{w['traffic']}.json").is_file()
    assert (ROOT / "cme_bench" / "workloads" / f"{w['name']}.json").is_file()
    assert w["chips"] in (1, 4)
    c = harness.cell(w["name"])
    assert c.traffic["entry"] in ("box", "table")
    assert set(c.limits["limits"]) == {"excess"}


@pytest.mark.parametrize("cfg", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file_matches_benchmark(cfg):
    mod = harness.load_module("configs", cfg["name"])
    assert mod.NAME == cfg["name"]
    assert mod.SOURCE == cfg["source"]
    assert mod.REDUCED == cfg["reduced"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])
    # a cell that cuts the horizon lists it
    for w in BENCH["workloads"]:
        if w["config"] == cfg["name"]:
            t = harness.cell(w["name"]).t_out
            assert t == mod.T_OUT or "t_out" in mod.REDUCED


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for name in CELLS:
        c = harness.cell(name)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer


@pytest.mark.parametrize("m", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric(m):
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m["workloads"]:
        assert cell in CELLS
        assert harness.reports(e2e[m["moves"]], cell)
    reader = harness.load_module("metrics", m["name"])
    assert reader.UNIT == m["unit"]
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    metrics = [m["name"] for g in ("end_to_end", "per_layer")
               for m in BENCH[g]]
    assert len(set(metrics)) == len(metrics)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_draws_repeat_for_a_seed_and_differ_across_seeds(seed):
    a = harness.draw(seed, 3, 10, 1.05)
    b = harness.draw(seed, 3, 10, 1.05)
    assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    assert np.all(a[0] >= 1 / 1.05) and np.all(a[0] <= 1.05)
    other = harness.draw(seed + 1, 3, 10, 1.05)
    assert not np.array_equal(a[0], other[0])
    later = harness.draw(seed, 4, 10, 1.05)
    assert not np.array_equal(a[0], later[0])


def test_draws_are_log_uniform():
    f = np.concatenate([harness.draw(5, i, 10, 1.05)[0] for i in range(400)])
    logs = np.log(f) / np.log(1.05)
    assert abs(logs.mean()) < 0.05
    assert abs(logs.var() - 1 / 3) < 0.03


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_window_starts_no_solve_after_it_closes(monkeypatch):
    clock = _Clock()
    walls = [3.0, 4.0, 2.5, 5.0, 6.0]

    def fake(c, model, seed, i, device, dtype=None):
        clock.t += walls[i - 1]
        return harness.Solve(i, np.ones(2), walls[i - 1], {"nstep": 1})

    monkeypatch.setattr(harness.time, "perf_counter", clock)
    monkeypatch.setattr(harness, "run_solve", fake)
    solves, window_s = harness.window(None, None, 1, 10.0, "cpu",
                                      log=lambda s: None)
    # solves start at 0, 3, 7 and 9.5; the one due at 14.5 is not started
    assert [sv.i for sv in solves] == [1, 2, 3, 4]
    assert window_s == pytest.approx(14.5)


def test_end_to_end_counts_whole_solves_only():
    c = harness.cell("goutsias6.table-t30")
    solves = [harness.Solve(i, None, w, {"nstep": 1})
              for i, w in enumerate([1.0, 2.0, 3.0, 4.0], 1)]
    solves.append(harness.Solve(5, None, 9.0, {}, fault="raised"))
    got = harness.end_to_end(c, solves, 12.0, 7.5)
    assert got["solve_s"]["value"] == pytest.approx(12.0 / 4)
    assert got["setup_s"]["value"] == 7.5
    assert got["solve_s_p95"]["value"] == pytest.approx(3.85)
    assert got["solve_s"]["unit"] == "s"
    toggle = harness.cell("toggle-customprop.box-t100")
    assert "solve_s_p95" not in harness.end_to_end(toggle, solves, 12.0, 7.5)


def test_device_time_per_solve_only_where_the_window_was_traced():
    c = harness.cell("goutsias6.box-t10")
    assert harness.device_timed(c)
    assert not harness.device_timed(harness.cell("goutsias6.table-t30"))
    assert not harness.device_timed(
        harness.cell("toggle-customprop.box-t100"))
    solves = [harness.Solve(i, None, 0.5, {"nstep": 1}) for i in range(1, 5)]
    solves.append(harness.Solve(5, None, 0.7, {}, fault="raised"))
    got = harness.end_to_end(c, solves, 2.0, 7.5, device_s=0.2)
    assert set(got) == {"setup_s", "device_s_per_solve"}
    assert got["device_s_per_solve"]["value"] == pytest.approx(0.2 / 4)
    # a run that traced no window (the CPU) reports set-up alone
    assert set(harness.end_to_end(c, solves, 2.0, 7.5)) == {"setup_s"}


def test_busy_seconds_of_nanosecond_intervals():
    # [0, 4) and [2, 6) overlap, [10, 12) apart: 8 ns
    assert devtrace.busy_seconds([0, 2, 10], [4, 6, 12]) == pytest.approx(
        8e-9)
    assert devtrace.busy_seconds([], []) == 0.0


def test_p95_over_all_solves():
    walls = list(np.linspace(1.0, 2.0, 101))
    assert harness.p95(walls) == pytest.approx(1.95)
    assert harness.p95([0.7]) == 0.7


def test_idle_is_a_union_of_intervals():
    # device: [0, 4) and [2, 6) overlap, [10, 12) apart: busy 8 of 20
    events = [("k1", True, 0, 0.0, 4.0), ("k2", True, 0, 2.0, 6.0),
              ("k1", True, 0, 10.0, 12.0),
              ("solve", False, 1, 0.0, 20.0),
              ("cudaStreamSynchronize", False, 1, 5.0, 6.0),
              ("aten::copy_", False, 1, 6.5, 9.5),
              ("cudaStreamSynchronize", False, 1, 11.0, 12.0)]
    p = devtrace.reduce(events, 20e-6)
    assert p.busy_s == pytest.approx(8e-6)
    assert p.syncs == 2
    assert p.device_ops["k1"] == (2, pytest.approx(6e-6))
    # idle: [6, 10) under aten::copy_ at its midpoint, [12, 20) under solve
    assert p.idle_by_host["aten::copy_"] == pytest.approx(4e-6)
    assert p.idle_by_host["solve"] == pytest.approx(8e-6)
    tr = harness.Trace(p, {"nstep": 1, "nreject": 1}, {})
    idle = harness.load_module("metrics", "device_idle_pct")
    assert idle.read(tr) == pytest.approx(60.0)
    syncs = harness.load_module("metrics", "host_syncs_per_step")
    assert syncs.read(tr) == pytest.approx(1.0)


def test_busy_runs():
    assert devtrace.busy_runs([], [])[0].size == 0
    s, e = devtrace.busy_runs([5, 0, 1], [6, 2, 3])
    assert s.tolist() == [0, 5] and e.tolist() == [3, 6]
    s, e = devtrace.busy_runs([0, 1], [10, 2])  # one inside the other
    assert s.tolist() == [0] and e.tolist() == [10]


def test_kernel_readers():
    p = devtrace.Profile(
        {"void sep_stencil_kernel<true>(Args)": (4, 20e-6),
         "void sep_stencil_kernel<false>(Args)": (6, 30e-6),
         "void expm_pade_kernel<true>(double const*)": (2, 300e-6),
         "Memcpy DtoH (Device -> Pageable)": (5, 1e-6)},
        0, 1e-3, 2e-3, {})
    tr = harness.Trace(p, {"nstep": 1, "nreject": 0}, {})
    assert harness.load_module("metrics", "stencil_us_per_matvec").read(
        tr) == pytest.approx(5.0)
    assert harness.load_module("metrics", "expm_us_per_call").read(
        tr) == pytest.approx(150.0)
    for base in ("stencil_us_per_matvec", "expm_us_per_call"):
        box = harness.load_module("metrics", base + ".box")
        assert box.read(tr) == harness.load_module("metrics", base).read(tr)
    assert harness.load_module("metrics", "copy_ms_per_solve").read(
        tr) == pytest.approx(1e-3)
    # the box solve passes through no table span: nothing to read
    assert harness.load_module("metrics", "expand_ms_per_solve").read(
        tr) is None
    table = harness.Trace(p, {"nstep": 1, "nreject": 0},
                          {"ssa_extend": [0.1, 0.2], "onestep_extend": [0.05],
                           "build_operator": [0.01, 0.02]})
    assert harness.load_module("metrics", "expand_ms_per_solve").read(
        table) == pytest.approx(350.0)
    assert harness.load_module("metrics", "operator_build_ms_per_solve").read(
        table) == pytest.approx(30.0)
    # a solve that copies nothing between host and card
    no_copy = harness.Trace(
        devtrace.Profile({"void k()": (1, 1e-6)}, 0, 1e-6, 1e-3, {}), {}, {})
    assert harness.load_module("metrics", "copy_ms_per_solve").read(
        no_copy) is None


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "cme_bench").rglob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".", 1)[0]
            assert top not in harness.FORBIDDEN, f"{f} imports {name}"


def test_reference_imports_nothing_of_the_program():
    for f in sorted((ROOT / "cme_bench" / "reference").glob("*.py")):
        for name in _imports(f):
            assert name.split(".", 1)[0] in (
                "__future__", "dataclasses", "math", "warnings", "numpy",
                "torch"), f"{f} imports {name}"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "krylovfspssa_tpu_torch_x", sys)
    assert "krylovfspssa_tpu" not in harness.forbidden_modules()


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "cme_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(cwd)})


def test_run_fails_without_a_cuda_device():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cme_bench", tmp_path / "cme_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.requires_cuda
def test_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "cme_bench/run.py", "--workload",
         "goutsias6.table-t30", "--seed", "5", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
