"""The port's compiler API and its CLI against the JAX package's, on the CPU.

``repro_torch.api`` (options, profiles, the ``Compiler`` session, the result
schema) and ``python -m repro_torch.compile`` are copies of the reference's
modules. Here they are held to the checked-in API snapshot
(``tests/data_api_surface.json``, read, never written) and to the reference
on the same inputs, with exact equality throughout: compile results and CLI
report rows are compared with their wall-clock fields (every key ending in
``_s``) removed. ``examples/quickstart_torch.py`` runs on the CPU.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import pytest

import repro_torch
import repro_torch.api as api
import repro_torch.core as core
from repro.api import Compiler as JCompiler
from repro.api import add_cli_args as jadd_cli_args
from repro.api import resolve_options as jresolve_options
from repro.compile import main as jcompile_main
from repro.core import CGRA as JCGRA
from repro.core.benchsuite import load_suite as jload_suite
from repro.core.mapper import clear_mapping_cache as jclear_mapping_cache
from repro_torch.api import (
    FAILURE_KINDS,
    PROFILES,
    Compiler,
    CompileOptions,
    CompileResult,
    add_cli_args,
    classify_failure,
    options_from_args,
    resolve_options,
)
from repro_torch.compile import main as compile_main
from repro_torch.core import CGRA, DFG, ArchSpec, Edge, get_preset, map_dfg, running_example
from repro_torch.core.benchsuite import load_suite
from repro_torch.core.mapper import clear_mapping_cache

_ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
with open(os.path.join(os.path.dirname(__file__), "data_api_surface.json")) as f:
    SNAPSHOT = json.load(f)

#: suite kernels that map in well under a second on 4x4 in deterministic
#: mode (cfd and hotspot3D take a minute or more there)
QUICK = ("aes", "backprop", "basicmath", "bitcount", "crc32", "fft", "gsm",
         "particlefilter", "sha2", "stringsearch")


@pytest.fixture(autouse=True)
def _fresh_memory_caches():
    clear_mapping_cache()
    jclear_mapping_cache()
    yield
    clear_mapping_cache()
    jclear_mapping_cache()


def _untimed(row):
    """A row without its wall-clock fields (every key ending in ``_s``, at
    any depth)."""
    if isinstance(row, dict):
        return {k: _untimed(v) for k, v in row.items() if not k.endswith("_s")}
    if isinstance(row, list):
        return [_untimed(v) for v in row]
    return row


# ---------------------------------------------------------------- surface

def test_api_and_core_exports_match_snapshot():
    assert sorted(api.__all__) == SNAPSHOT["api_exports"]
    assert sorted(core.__all__) == SNAPSHOT["core_exports"]
    for name in api.__all__:
        assert hasattr(api, name), name
    for name in core.__all__:
        assert hasattr(core, name), name


def test_options_profiles_and_row_schema_match_snapshot():
    assert [f.name for f in dataclasses.fields(CompileOptions)] == (
        SNAPSHOT["compile_options_fields"])
    assert sorted(PROFILES) == SNAPSHOT["profiles"]
    row = CompileResult(name="x", ok=False).as_dict()
    assert sorted(row) == SNAPSHOT["result_row_keys"]
    assert sorted(row["phases"]) == SNAPSHOT["result_phase_keys"]
    assert sorted(row["trace"]) == SNAPSHOT["result_trace_keys"]


def test_top_level_lazy_exports():
    assert repro_torch.Compiler is api.Compiler
    assert repro_torch.CompileOptions is CompileOptions
    assert repro_torch.resolve_options is api.resolve_options
    with pytest.raises(AttributeError):
        repro_torch.no_such_name


# ---------------------------------------------------------------- options

@pytest.mark.parametrize("profile", sorted(SNAPSHOT["profiles"]))
def test_profiles_match_reference(profile):
    mine = resolve_options(profile, seed=7, max_slack=1)
    ref = jresolve_options(profile, seed=7, max_slack=1)
    assert mine.as_dict() == ref.as_dict()
    assert mine.to_json() == ref.to_json()
    assert CompileOptions.from_json(ref.to_json()) == mine
    assert mine.mapper_kwargs() == ref.mapper_kwargs()


def test_cli_flags_match_reference():
    ap, jap = argparse.ArgumentParser(), argparse.ArgumentParser()
    add_cli_args(ap)
    jadd_cli_args(jap)

    def flags(parser):
        return sorted((a.dest, tuple(a.option_strings), a.default)
                      for a in parser._actions if a.dest != "help")

    assert flags(ap) == flags(jap)
    argv = ["--profile", "fast", "--max-slack", "1", "--no-cache", "--jobs", "3"]
    assert options_from_args(ap.parse_args(argv)).as_dict() == (
        jresolve_options("fast", max_slack=1, use_cache=False, jobs=3).as_dict())
    assert options_from_args(ap.parse_args([])) == CompileOptions()
    with pytest.raises(ValueError, match="unknown profile"):
        resolve_options("turbo")


def test_map_dfg_shim_equals_the_compiler():
    kw = {"deterministic": True, "use_cache": False, "max_slack": 1, "seed": 3}
    a = map_dfg(running_example(), CGRA(2, 2), **kw)
    b = Compiler(CGRA(2, 2), resolve_options(**kw)).compile(running_example())
    assert a.ok and b.ok
    assert (a.mapping.ii, a.mapping.t_abs, a.mapping.placement) == (
        b.ii, b.mapping.t_abs, b.mapping.placement)
    for bad in ({"jobs": 4}, {"deadline_s": 1.0}, {"profile": "fast"},
                {"arch": "paper_homogeneous_4x4"}):
        with pytest.raises(TypeError, match="unexpected keyword"):
            map_dfg(running_example(), CGRA(2, 2), **bad)


# --------------------------------------------------------------- Compiler

@pytest.mark.parametrize("name", QUICK)
def test_compiler_4x4_deterministic_ci_matches_reference(name):
    mine = Compiler(CGRA(4, 4), "deterministic-ci").compile(load_suite([name])[name])
    ref = JCompiler(JCGRA(4, 4), "deterministic-ci").compile(jload_suite([name])[name])
    assert mine.ok and ref.ok
    assert _untimed(mine.as_dict()) == _untimed(ref.as_dict())
    assert (mine.mapping.t_abs, mine.mapping.placement) == (
        ref.mapping.t_abs, ref.mapping.placement)


def test_compile_batch_rows_match_reference():
    names = ["bitcount", "fft", "gsm"]
    mine = Compiler(CGRA(4, 4), "deterministic-ci").compile_batch(
        list(load_suite(names).values()))
    ref = JCompiler(JCGRA(4, 4), "deterministic-ci").compile_batch(
        list(jload_suite(names).values()))
    assert mine.ok and ref.ok and [r.name for r in mine] == names
    assert _untimed(mine.as_dict()) == _untimed(ref.as_dict())
    for a, b in zip(mine, ref):
        assert (a.mapping.t_abs, a.mapping.placement) == (
            b.mapping.t_abs, b.mapping.placement)


def test_compile_batch_disk_provenance(tmp_path):
    suite = list(load_suite(["bitcount", "fft"]).values())
    comp = Compiler(CGRA(4, 4), resolve_options(cache_dir=str(tmp_path),
                                                jobs=1, deadline_s=30.0))
    cold = comp.compile_batch(suite)
    assert cold.cache_counters["solved"] == 2
    clear_mapping_cache()
    warm = comp.compile_batch(suite)
    assert warm.cache_counters["disk_hits"] == 2
    assert all(r.source == "disk" for r in warm)
    assert [(r.mapping.t_abs, r.mapping.placement) for r in warm] == [
        (r.mapping.t_abs, r.mapping.placement) for r in cold]
    assert len(comp.cache) == 2


def test_compiler_target_resolution(tmp_path):
    path = tmp_path / "paper.json"
    get_preset("paper_homogeneous_4x4").save(str(path))
    targets = [CGRA(4, 4), get_preset("paper_homogeneous_4x4"),
               "paper_homogeneous_4x4", str(path)]
    cgras = [Compiler(t).cgra for t in targets]
    cgras.append(Compiler(options=resolve_options(arch="paper_homogeneous_4x4")).cgra)
    assert all(c == cgras[0] for c in cgras)
    big, jbig = Compiler("mesh_50x50").cgra, JCompiler("mesh_50x50").cgra
    assert (big.rows, big.cols, big.arch_token()) == (50, 50, jbig.arch_token())
    with pytest.raises(ValueError, match="no target machine"):
        Compiler()
    with pytest.raises(TypeError, match="target"):
        Compiler(42)


def test_compile_racing_and_session_overrides():
    comp = Compiler(CGRA(2, 2), "deterministic-ci")
    res = comp.compile_racing(running_example(), workers=4)
    assert res.ok and res.ii == 4 and res.mapping.validate() == []
    assert comp.compile(running_example(), seed=5).ok
    assert comp.options.seed == 0
    with pytest.raises(TypeError):
        comp.compile(running_example(), bogus=1)


def test_failure_codes_match_reference():
    spec = ArchSpec(name="alu_only", rows=2, cols=2, pe_classes=(("alu",),) * 4)
    mul = DFG(num_nodes=3, ops=["input", "input", "mul"],
              edges=[Edge(0, 2), Edge(1, 2)])
    res = Compiler(spec, "deterministic-ci").compile(mul)
    assert not res.ok and res.failure == "infeasible" and res.ii is None
    assert Compiler(spec).validate_workload([mul]) != []
    exhausted = Compiler(CGRA(1, 1), "deterministic-ci").compile(
        load_suite(["bitcount"])["bitcount"], max_ii=4)
    jexhausted = JCompiler(JCGRA(1, 1), "deterministic-ci").compile(
        jload_suite(["bitcount"])["bitcount"], max_ii=4)
    assert _untimed(exhausted.as_dict()) == _untimed(jexhausted.as_dict())
    assert exhausted.failure in FAILURE_KINDS
    for ok, reason, cancelled, want in (
            (True, "", False, None),
            (False, "infeasible by capability: x", False, "infeasible"),
            (False, "time budget exhausted", False, "budget-exhausted"),
            (False, "search space exhausted up to II=9", False, "search-exhausted"),
            (False, "anything", True, "cancelled"),
            (False, "ValueError: bad dfg", False, "error"),
            (False, "worker lost: pool broken twice", False, "worker-lost"),
            (False, "weird", False, "unknown")):
        assert classify_failure(ok, reason, cancelled=cancelled) == want


# -------------------------------------------------------------------- CLI

def test_compile_cli_rows_match_reference(tmp_path):
    """``python -m repro_torch.compile --deterministic`` writes the
    reference CLI's report, timings removed. The quick suite kernels stand
    in for ``--suite``: cfd and hotspot3D alone take over 90 s a package at
    4x4 in deterministic mode."""
    argv = ["--size", "4", "--deterministic", "--jobs", "2", "--quiet"]
    for name in QUICK:
        argv += ["--bench", name]
    mine, ref = tmp_path / "port.json", tmp_path / "ref.json"
    assert compile_main(argv + ["--report", str(mine)]) == 0
    assert jcompile_main(argv + ["--report", str(ref)]) == 0
    mine, ref = json.loads(mine.read_text()), json.loads(ref.read_text())
    assert [j["name"] for j in mine["jobs"]] == sorted(QUICK)
    assert mine["ok"] and mine["num_workers"] == 2
    assert _untimed(mine) == _untimed(ref)


def test_compile_cli_runs_as_a_module(tmp_path):
    """The entry point users call, in a process of its own; a second run on
    the same cache directory is served from disk."""
    report = tmp_path / "r.json"
    cmd = [sys.executable, "-m", "repro_torch.compile", "--bench", "bitcount",
           "--bench", "gsm", "--size", "4", "--jobs", "1",
           "--cache-dir", str(tmp_path / "maps"), "--report", str(report)]
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    for want in ("solved", "disk_hits"):
        out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert json.loads(report.read_text())["cache"][want] == 2
    assert compile_main([]) == 2


def test_quickstart_torch_example_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "examples", "quickstart_torch.py"),
         "--device", "cpu", "--profile", "deterministic-ci"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "functional equivalence OK" in out.stdout
    assert "cgra_sim on cpu" in out.stdout
