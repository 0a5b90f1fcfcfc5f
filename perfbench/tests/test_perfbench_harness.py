"""The harness: files found by name, BENCHMARK.json's shape, the result
line, and the isolation from JAX; on the CPU at a small size."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness, isolation, suite

from ._small import run_small, small_context

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def test_every_file_is_found_by_name():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell = suite.load_cell(w["name"])
        assert cell["config"] == w["config"]
        assert (harness.HERE / "drivers" / f"{cell['kind']}.py").is_file()
        assert hasattr(harness.load_driver(cell["kind"]), "Driver")
    for c in bench["configs"]:
        cfg = suite.load_config(c["name"])
        assert (ROOT / c["file"]).resolve() == (harness.HERE / "configs" / f"{c['name']}.json")
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        for k in cfg["kernels"]:
            assert suite.dfg_path(k).is_file() and suite.mapping_path(c["name"], k).is_file()
    for m in bench["per_layer"]:
        assert harness.read_metric(m["name"], {}) is None, m["name"]


def test_benchmark_json_keeps_the_contracts_shape():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"] and bench["command"][1] == "perfbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], cell)
    for cell in CELLS:
        reported = [m["name"] for m in bench["end_to_end"] if harness.applies(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(harness.applies(m, cell) for m in bench["per_layer"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200 and c["file"].startswith("perfbench/")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_the_result_line_has_the_contracts_shape(cell, trace):
    result = run_small(small_context(cell, trace=bool(trace)))
    line = json.loads(result.line())
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    bench = harness.benchmark()
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"] for m in bench[kind] if harness.applies(m, cell)}
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name] and m["value"] > 0
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU run has no device trace: only the program's own counters
        assert set(line["metrics"]) <= set(want)
    else:
        assert set(line["metrics"]) == set(want)


def test_forbidden_modules_compares_whole_top_level_names():
    assert isolation.forbidden_modules(["repro_torch.core", "jaxtyping", "numpy"]) == []
    assert isolation.forbidden_modules(["repro.core", "jax", "jaxlib.xla", "flax"]) == [
        "flax", "jax", "jaxlib.xla", "repro.core"]


def _python(code: str, cwd: Path, pythonpath: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=pythonpath, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys; sys.path[:0] = ['.', 'src']\n"
        "from perfbench.tests._small import run_small, small_context\n"
        "from perfbench import isolation\n"
        "for cell in ('table3-mesh4.exec', 'table3-mesh4.compile'):\n"
        "    assert run_small(small_context(cell, trace=True)).correct\n"
        "print(isolation.forbidden_modules())\n")
    out = _python(code, ROOT, "")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_a_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "table3-mesh4.exec",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_a_run_fails(tmp_path):
    """A checkout of only BENCHMARK.json and perfbench/ cannot run a cell."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "from perfbench.tests._small import run_small, small_context\n"
            "run_small(small_context('table3-mesh4.exec'))\n")
    out = _python(code, tmp_path, "")
    assert out.returncode != 0 and "repro_torch" in out.stderr
