"""The port's ``obs``: spans as profiler annotations, the fork guard, the
executor's spans and the probe outcomes of the mapper, on the CPU."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.kernels  # noqa: F401  (installs obs's profiler hook)
from repro_torch import obs
from repro_torch.core import CGRA, DFG, Edge
from repro_torch.core.benchsuite import load_suite
from repro_torch.core.mapper import map_dfg
from repro_torch.core.mono import SpaceStats, find_monomorphism
from repro_torch.core.service import CompileJob, compile_many
from repro_torch.core.space_backends import SpaceBudget, create_space_backend
from repro_torch.kernels.ops import cgra_run, compile_program

EXEC_SPANS = ["exec.run", "exec.tables", "exec.inputs", "cgra_sim.fill",
              "cgra_sim.launch", "exec.gather"]
SPACE_OUTCOMES = {"found", "exhausted", "node_budget", "timeout", "cancelled"}
TIME_OUTCOMES = {"found", "exhausted", "timeout"}


def _annotations(prof, tmp_path) -> list[dict]:
    path = str(tmp_path / "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e.get("ph") == "X"), key=lambda e: (e["ts"], -e["dur"]))


def _key(mapping) -> tuple:
    return mapping.ii, tuple(mapping.t_abs), tuple(mapping.placement)


def test_disabled_spans_cost_little_and_never_enter_the_profiler(monkeypatch):
    entered = []
    monkeypatch.setattr(obs, "_ANNOTATE", lambda name: entered.append(name))
    assert obs.get_tracer() is None and obs._PROFILING is not None
    assert obs.span("exec.run") is obs._NULL_SPAN
    n, best = 100_000, float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            with obs.span("exec.run"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert entered == []
    assert best < 3e-6, f"{best * 1e6:.3f} us a disabled span"


def test_cgra_run_spans_nest_under_the_profiler(tmp_path):
    dfg = load_suite(["bitcount"])["bitcount"]
    prog = compile_program(map_dfg(dfg, CGRA(4, 4), deterministic=True).mapping)
    rng = np.random.default_rng(0)
    inputs = {v: rng.uniform(-4, 4, (3, 5)).astype(np.float32) for v in prog.input_nodes()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs, _ = cgra_run(prog, inputs, 3, device="cpu")
    spans = [e for e in _annotations(prof, tmp_path) if e["name"] in EXEC_SPANS]
    assert [e["name"] for e in spans] == EXEC_SPANS
    run, steps = spans[0], spans[1:]
    for a, b in zip(steps, steps[1:]):
        assert a["ts"] + a["dur"] <= b["ts"] + 1e-3
    for e in steps:
        assert run["ts"] <= e["ts"] and e["ts"] + e["dur"] <= run["ts"] + run["dur"] + 1e-3
    # the same call outside the profiler opens no annotation and agrees
    again, _ = cgra_run(prog, inputs, 3, device="cpu")
    assert all(torch.equal(outs[v], again[v]) for v in outs)


def test_with_a_tracer_and_the_profiler_a_span_goes_to_both(tmp_path):
    with obs.tracing() as tracer, profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("exec.run", batch=3) as sp:
            sp.set(done=True)
    assert [(e["name"], e["args"]) for e in tracer.events] == [
        ("exec.run", {"batch": 3, "done": True})]
    assert [e["name"] for e in _annotations(prof, tmp_path)] == ["exec.run"]


def test_workers_forked_under_the_profiler_never_enter_it(tmp_path, monkeypatch):
    """compile_many forks its workers while the profiler records: the
    mappings are those of an untraced run, every worker's probe spans carry
    an outcome, and only this process opens annotations."""
    callers = tmp_path / "callers"

    def annotate(name):
        with open(callers, "a") as f:
            f.write(f"{os.getpid()}\n")
        return record_function(name)

    monkeypatch.setattr(obs, "_ANNOTATE", annotate)
    suite = load_suite(["bitcount", "fft", "gsm"])
    jobs = [CompileJob(d, CGRA(4, 4), name=k) for k, d in suite.items()]
    plain = compile_many(jobs, jobs=2, deterministic=True)
    shards = tmp_path / "obs"
    shards.mkdir()
    with profile(activities=[ProfilerActivity.CPU]):
        with record_function("window"):
            traced = compile_many(jobs, jobs=2, deterministic=True, trace_dir=str(shards))
    assert traced.ok and traced.num_workers == 2
    assert ([(j.name, j.ii, j.t_abs, j.placement) for j in traced.jobs]
            == [(j.name, j.ii, j.t_abs, j.placement) for j in plain.jobs])
    events, _ = obs.merge_shards(str(shards))
    assert {e["pid"] for e in events} - {os.getpid()}
    probes = {"space.probe": SPACE_OUTCOMES, "time.probe": TIME_OUTCOMES}
    seen = {name: [e["args"]["outcome"] for e in events if e["name"] == name]
            for name in probes}
    for name, allowed in probes.items():
        assert seen[name] and set(seen[name]) <= allowed, (name, seen[name])
        assert "found" in seen[name]
    pids = set(callers.read_text().split()) if callers.exists() else set()
    assert pids <= {str(os.getpid())}


@pytest.mark.parametrize("name", ["bitcount", "fft", "gsm"])
def test_a_traced_deterministic_4x4_compile_is_bit_identical(name, tmp_path):
    dfg = load_suite([name])[name]
    plain = map_dfg(dfg, CGRA(4, 4), deterministic=True)
    with obs.tracing() as tracer, profile(activities=[ProfilerActivity.CPU]):
        traced = map_dfg(dfg, CGRA(4, 4), deterministic=True)
    assert _key(traced.mapping) == _key(plain.mapping)
    outcomes = [e["args"]["outcome"] for e in tracer.events if e["name"] == "space.probe"]
    assert outcomes[-1] == "found" and set(outcomes) <= SPACE_OUTCOMES


def _path(n: int) -> DFG:
    return DFG(num_nodes=n, ops=["add"] * n, edges=[Edge(i, i + 1) for i in range(n - 1)],
               name=f"path{n}")


@pytest.mark.parametrize("budget, outcome, count", [
    ({"timeout_s": 0.0}, "timeout", "deadline_stops"),
    ({"timeout_s": 1e-4, "restarts": 1}, "timeout", "deadline_stops"),
    ({"timeout_s": None, "node_budget": 1}, "node_budget", "budget_stops"),
])
def test_a_forced_stop_names_its_outcome(budget, outcome, count):
    """A 300-node path on 20x20 in one step: a dive visits more than the
    256 nodes between two looks at its deadline, and more than one node."""
    dfg = _path(300)
    stats = SpaceStats()
    sol = find_monomorphism(dfg, CGRA(20, 20), [0] * dfg.num_nodes, 1,
                            stats=stats, **budget)
    assert sol is None and getattr(stats, count) >= 1
    assert stats.outcome(found=False) == outcome
    assert stats.outcome(found=False, cancelled=True) == "cancelled"


def test_an_exhausted_probe_and_the_outcomes_precedence():
    # 5 nodes cannot share the one step of a 2x2 fabric
    stats = SpaceStats()
    assert find_monomorphism(_path(5), CGRA(2, 2), [0] * 5, 1, stats=stats) is None
    assert (stats.deadline_stops, stats.budget_stops) == (0, 0)
    assert stats.outcome(found=False) == "exhausted"
    both = SpaceStats(deadline_stops=1, budget_stops=1)
    assert both.outcome(found=False) == "timeout"
    assert both.outcome(found=True, cancelled=True) == "found"


@pytest.mark.parametrize("budget, outcome", [
    ({"timeout_s": None, "node_budget": 1, "restarts": 2}, "node_budget"),
    ({"timeout_s": 0.0}, "timeout"),
])
def test_a_failed_anneal_probe_names_where_it_stopped(budget, outcome):
    """A 9-node star cannot lie in one step of a 4x4 mesh (a PE has four
    neighbours); anneal proves nothing, so each restart it runs ends at a
    budget or the clock, never as ``exhausted``."""
    star = DFG(num_nodes=9, ops=["add"] * 9, edges=[Edge(0, i) for i in range(1, 9)],
               name="star9")
    stats = SpaceStats()
    engine = create_space_backend("anneal")
    assert engine.place(star, CGRA(4, 4), [0] * 9, 1, budget=SpaceBudget(**budget),
                        seed=2**31 + 7, stats=stats) is None
    assert stats.outcome(found=False) == outcome
