"""The harness on the CPU: BENCHMARK.json against the contract's shape,
every name resolving to its files, no JAX anywhere, and no run without a
card."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
# a check's runs: 2 + 14 per cell at full size, each run_seconds + 60
# s, each cell 2 x 90 s to compile, 1200 s spare, within 43 200 s
MAX_CELLS = 24


@pytest.fixture(scope="module")
def bench():
    return common.load_benchmark()


def test_benchmark_json_shape(bench):
    assert set(bench) == TOP_KEYS
    assert bench["command"] == ["python3", "-m", "benchmark.run"]
    assert bench["paths"] == ["benchmark"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * MAX_CELLS
    assert (runs * (bench["run_seconds"] + 60) + MAX_CELLS * 2 * 90
            + 1200) <= 43200
    for c in bench["configs"]:
        assert set(c) == CONFIG_KEYS
    for w in bench["workloads"]:
        assert set(w) == CELL_KEYS
        assert w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for c in bench["configs"]:
        for key in c["reduced"]:
            assert NAME.match(key), key
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in bench["workloads"]]
                 + [c["why"] for c in bench["configs"]]
                 + [c["source"] for c in bench["configs"]]
                 + [m["layer"] for m in bench["per_layer"]]
                 + bench["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_name_resolves(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        c = configs[w["config"]]
        assert (common.ROOT / c["file"]).is_file()
        cfg = common.load_config(w["config"])
        assert cfg["name"] == w["config"]
        assert cfg["reduced"] == c["reduced"]
        assert (common.ROOT / cfg["repo_config"]).is_file()
        mix = common.load_mix(w["traffic"])
        assert (common.HERE / "kinds" / f"{mix['kind']}.py").is_file()
        limits = common.load_limits(w["name"])
        assert all(isinstance(v, (int, float)) for v in limits.values())
        for section in ("end_to_end", "per_layer"):
            for m in common.cell_metrics(bench, w["name"], section):
                assert callable(common.load_reader(m["name"]))
    for c in bench["configs"]:
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_layer_metrics_move_what_their_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert m in common.cell_metrics(bench, cell, "per_layer")
            assert e2e[m["moves"]] in common.cell_metrics(
                bench, cell, "end_to_end")
    for w in bench["workloads"]:
        reported = common.cell_metrics(bench, w["name"], "end_to_end")
        assert any(m["name"] == "setup_s" for m in reported)
        assert len(reported) >= 2
        assert common.cell_metrics(bench, w["name"], "per_layer")


def _sources():
    return sorted(p for p in common.HERE.rglob("*.py")
                  if "tests" not in p.relative_to(common.HERE).parts)


def test_no_jax_in_the_sources():
    for path in _sources():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in common.FORBIDDEN_MODULES, (
                    path, name)


def test_no_jax_loaded_by_the_harness():
    """Everything a run imports, the port's request path included."""
    code = (
        "import benchmark.run, benchmark.control, benchmark.kinds.sweep\n"
        "from benchmark import common\n"
        "from second_tpu_torch.core.inference import InferenceContext\n"
        "for p in (common.HERE / 'metrics').glob('*.py'):\n"
        "    common.load_reader(p.stem)\n"
        "print(','.join(common.forbidden_loaded()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(common.ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_forbidden_names_compare_whole(monkeypatch):
    """The port's name begins with the JAX package's: top-level names
    are compared whole."""
    before = set(common.forbidden_loaded())
    monkeypatch.setitem(sys.modules, "second_tpu_torch_probe.sub", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert set(common.forbidden_loaded()) == before
    monkeypatch.setitem(sys.modules, "second_tpu.probe", sys)
    assert set(common.forbidden_loaded()) - before <= {"second_tpu"}
    assert "second_tpu" in common.forbidden_loaded()


def test_no_run_without_a_card(tmp_path):
    """With no CUDA device visible the run exits non-zero and prints no
    result line: it never falls back to the CPU."""
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "pointpillars.sweep", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                 PYTHONPATH=str(common.ROOT)))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_run_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark."""
    import shutil

    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "car_fhd.sweep", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_host_allocator_settings(bench):
    """Every configuration's allocator settings name parameters the
    harness knows, and this C library takes them; an unknown one ends the
    run."""
    code = ("import sys\n"
            "from benchmark import common\n"
            "common.set_host_allocator(common.load_config(sys.argv[1]))\n")
    for c in bench["configs"]:
        cfg = common.load_config(c["name"])
        assert set(cfg.get("host", {}).get("mallopt", {})) <= set(
            common.MALLOPT_PARAMS)
        out = subprocess.run([sys.executable, "-c", code, c["name"]],
                             cwd=common.ROOT, capture_output=True, text=True,
                             timeout=60)
        assert out.returncode == 0, out.stderr
    bad = {"host": {"mallopt": {"M_ARENA_MAX": 1}}}
    with pytest.raises(SystemExit):
        common.set_host_allocator(bad)


def test_percentile():
    assert common.percentile(list(range(101)), 95) == 95
    assert common.percentile([3.0], 50) == 3.0


def test_trace_reduction(tmp_path):
    """Busy time is the union of device intervals inside the requests'
    span; idle gaps are named by the stage and innermost host op."""
    from benchmark import trace

    ev = [
        {"cat": "user_annotation", "name": "bench.request", "ts": 0,
         "dur": 100},
        {"cat": "user_annotation", "name": "bench.host_prep", "ts": 0,
         "dur": 40},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 10, "dur": 20},
        {"cat": "user_annotation", "name": "bench.request", "ts": 100,
         "dur": 100},
        {"cat": "kernel", "name": "k1", "ts": 40, "dur": 30},
        {"cat": "kernel", "name": "k2", "ts": 60, "dur": 20},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 150, "dur": 80},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    out = trace.reduce_trace(path)
    assert out["window_s"] == pytest.approx(200e-6)
    assert out["busy_s"] == pytest.approx((80 - 40 + 200 - 150) * 1e-6)
    assert out["requests"] == 2
    gaps = dict(out["idle_gaps"])
    assert gaps["host_prep/aten::copy_"] == pytest.approx(40e-6)
    assert sum(gaps.values()) == pytest.approx(200e-6 - out["busy_s"])
    assert dict(out["device_ops"])["k1"] == pytest.approx(30e-6)
