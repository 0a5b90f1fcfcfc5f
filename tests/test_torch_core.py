"""The port's mapper and data structures against the JAX package's.

``repro_torch.core`` is a copy of the framework-free mapper; deterministic
runs must land on the same mappings bit for bit, and the data structures and
the scalar interpreter must agree exactly.
"""

import hashlib
import json
import os
import random

import pytest

from repro.core import CGRA as JCGRA
from repro.core import map_dfg as jmap_dfg
from repro.core.mapper import clear_mapping_cache as jclear_mapping_cache
from repro.core import running_example as jrunning_example
from repro.core.benchsuite import load_suite as jload_suite
from repro.core.benchsuite import route_stress_dfg as jroute_stress_dfg
from repro.core.dfg import splice_routes as jsplice_routes
from repro.core.simulate import check_equivalence as jcheck_equivalence
from repro.core.simulate import interpret_dfg as jinterpret_dfg
from repro.core.simulate import register_pressure_by_pe as jregister_pressure_by_pe
from repro.core.space_backends import resolve_space_backend_name as jresolve_space_backend_name
from repro.core.time_backends import BackendUnavailable as JBackendUnavailable
from repro.core.time_backends import available_backends as javailable_backends
from repro_torch.core import CGRA, DFG, map_dfg, running_example
from repro_torch.core.mapper import clear_mapping_cache
from repro_torch.core.benchsuite import TABLE3_BENCHMARKS, load_suite, route_stress_dfg
from repro_torch.core.dfg import splice_routes
from repro_torch.core.simulate import (
    check_equivalence,
    interpret_dfg,
    register_pressure_by_pe,
)
from repro_torch.core.space_backends import resolve_space_backend_name
from repro_torch.core.time_backends import BackendUnavailable, available_backends
from repro_torch.interop import mapping_from_plain, plain_mapping

_GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "data_golden_4x4.json")
_SUITE = sorted(TABLE3_BENCHMARKS)


def _mapping_sha(mapping) -> str:
    # the hash of tests/test_api.py's golden file
    return hashlib.sha1(json.dumps(
        {"t_abs": mapping.t_abs, "placement": mapping.placement},
        separators=(",", ":")).encode()).hexdigest()


# kernels that map in a few seconds here; susan and lud take longer
@pytest.mark.parametrize("name", ["bitcount", "gsm", "fft", "aes", "sha1"])
def test_deterministic_4x4_matches_golden(name):
    with open(_GOLDEN_PATH) as f:
        golden = json.load(f)[name]
    res = map_dfg(load_suite([name])[name], CGRA(4, 4), deterministic=True,
                  use_cache=False)
    assert res.ok, res.reason
    assert res.mapping.ii == golden["ii"]
    assert _mapping_sha(res.mapping) == golden["sha1"]


@pytest.mark.parametrize("name", _SUITE + ["running_example", "route_stress"])
def test_dfg_json_matches_reference(name):
    if name == "running_example":
        mine, ref = running_example(), jrunning_example()
    elif name == "route_stress":
        mine, ref = route_stress_dfg(), jroute_stress_dfg()
    else:
        mine, ref = load_suite([name])[name], jload_suite([name])[name]
    assert mine.to_json() == ref.to_json()
    assert mine.stable_hash() == ref.stable_hash()
    assert mine.rec_ii() == ref.rec_ii()
    assert DFG.from_json(ref.to_json()).to_json() == ref.to_json()


@pytest.mark.parametrize("name", _SUITE + ["running_example"])
def test_interpret_dfg_matches_reference(name):
    if name == "running_example":
        mine, ref = running_example(), jrunning_example()
    else:
        mine, ref = load_suite([name])[name], jload_suite([name])[name]
    rng = random.Random(name)
    num_iters = 6
    inputs = {v: [round(rng.uniform(-4, 4), 3) for _ in range(num_iters)]
              for v in mine.nodes if mine.ops[v] == "input"}
    assert interpret_dfg(mine, inputs, num_iters) == jinterpret_dfg(ref, inputs, num_iters)


def test_splice_routes_matches_reference():
    specs = [(1, 3, 0, 2), (3, 4, 0, 1)]
    mine, routes = splice_routes(route_stress_dfg(), specs)
    ref, jroutes = jsplice_routes(jroute_stress_dfg(), specs)
    assert mine.to_json() == ref.to_json()
    assert [r.spec() for r in routes] == [r.spec() for r in jroutes]


@pytest.mark.parametrize("grid", [(2, 2), (3, 3)])
def test_search_path_and_stats_match_reference(grid):
    """Same mapping and the same search counters as the JAX mapper."""
    mine = map_dfg(running_example(), CGRA(*grid), deterministic=True)
    ref = jmap_dfg(jrunning_example(), JCGRA(*grid), deterministic=True)
    assert mine.ok and ref.ok
    assert (mine.mapping.ii, mine.mapping.t_abs, mine.mapping.placement) == (
        ref.mapping.ii, ref.mapping.t_abs, ref.mapping.placement)
    for f in ("rounds", "windows_opened", "time_solutions_tried",
              "mono_failures", "space_nodes_visited", "m_ii", "res_ii",
              "rec_ii", "backend", "space_backend", "time_steps"):
        assert getattr(mine.stats, f) == getattr(ref.stats, f), f


def test_simulator_matches_reference_on_a_carried_mapping():
    ref = jmap_dfg(jload_suite(["gsm"])["gsm"], JCGRA(4, 4), deterministic=True)
    mine = mapping_from_plain(plain_mapping(ref.mapping))
    assert mine.validate() == ref.mapping.validate()
    assert register_pressure_by_pe(mine) == jregister_pressure_by_pe(ref.mapping)
    a = check_equivalence(mine, num_iters=6, seed=3)
    b = jcheck_equivalence(ref.mapping, num_iters=6, seed=3)
    assert a.outputs == b.outputs and a.cycles == b.cycles


def test_interop_rejects_an_invalid_mapping():
    res = map_dfg(running_example(), CGRA(2, 2), deterministic=True)
    plain = plain_mapping(res.mapping)
    assert mapping_from_plain(plain).placement == res.mapping.placement
    plain["placement"] = [0] * len(plain["placement"])
    with pytest.raises(ValueError, match="invalid"):
        mapping_from_plain(plain)


def _cache_files(root):
    """{relative path: parsed JSON} of every entry under a disk cache."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                out[os.path.relpath(path, root)] = json.load(f)
    return out


def test_unported_backends_raise(tmp_path):
    """What the reference lacks (z3 here) raises alike in both packages;
    the anneal engine and the disk cache, which the port now carries, act
    as in the reference (exact equality throughout)."""
    dfg, cgra = running_example(), CGRA(2, 2)
    # z3 is registered as in the reference, which is where its absence shows
    assert available_backends() == javailable_backends() == {"cp": True, "z3": False}
    with pytest.raises(BackendUnavailable, match="^time backend 'z3' is not importable$"):
        map_dfg(dfg, cgra, backend="z3")
    with pytest.raises(JBackendUnavailable, match="^time backend 'z3' is not importable$"):
        jmap_dfg(jrunning_example(), JCGRA(2, 2), backend="z3")
    mine = map_dfg(dfg, cgra, space_backend="anneal", deterministic=True,
                   use_cache=False)
    ref = jmap_dfg(jrunning_example(), JCGRA(2, 2), space_backend="anneal",
                   deterministic=True, use_cache=False)
    assert mine.ok and ref.ok and mine.stats.space_backend == "anneal"
    assert (mine.mapping.ii, mine.mapping.t_abs, mine.mapping.placement) == (
        ref.mapping.ii, ref.mapping.t_abs, ref.mapping.placement)
    # auto is fabric-sized: exact up to 400 PEs in both packages
    assert resolve_space_backend_name("auto", CGRA(20, 20)) == "exact"
    assert jresolve_space_backend_name("auto", JCGRA(20, 20)) == "exact"
    # above, the reference takes anneal and the port, on a homogeneous mesh,
    # the window engine (tests/test_torch_window.py)
    assert resolve_space_backend_name("auto", CGRA(21, 20)) == "window"
    assert jresolve_space_backend_name("auto", JCGRA(21, 20)) == "anneal"
    mine_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    clear_mapping_cache()
    jclear_mapping_cache()
    mine = map_dfg(dfg, cgra, cache_dir=str(mine_dir))
    ref = jmap_dfg(jrunning_example(), JCGRA(2, 2), cache_dir=str(ref_dir))
    assert mine.ok and ref.ok
    assert mine.stats.disk_cache_lookups == ref.stats.disk_cache_lookups == 1
    files = _cache_files(mine_dir)
    assert len(files) == 1 and sorted(files) == sorted(_cache_files(ref_dir))
    (entry,) = files.values()
    assert entry["ii"] == mine.mapping.ii
    assert entry["placement"] == mine.mapping.placement


@pytest.mark.parametrize("z3_available", [True, False])
def test_auto_time_backend_resolves_as_in_the_reference(monkeypatch, z3_available):
    """``auto`` takes z3 wherever z3 is importable, in both packages; z3's
    availability is stubbed in each registry, so this needs no z3."""
    from repro.core.time_backends import base as jbase
    from repro_torch.core.time_backends import base

    for registry in (base._REGISTRY, jbase._REGISTRY):
        monkeypatch.setattr(registry["z3"], "available", lambda: z3_available)
    want = "z3" if z3_available else "cp"
    assert base.resolve_backend_name("auto") == jbase.resolve_backend_name("auto") == want
    assert base.available_backends() == jbase.available_backends()


def test_cache_dir_from_environment_raises(monkeypatch, tmp_path):
    """``$REPRO_CACHE_DIR`` is honoured as in the reference: the first
    compile writes the entry, a compile after the LRU is cleared is served
    from disk, and both packages write the same files."""
    dfg = load_suite(["gsm"])["gsm"]
    jdfg = jload_suite(["gsm"])["gsm"]
    layouts = []
    for tag, fn, clear, graph, grid in (
            ("port", map_dfg, clear_mapping_cache, dfg, CGRA(4, 4)),
            ("ref", jmap_dfg, jclear_mapping_cache, jdfg, JCGRA(4, 4))):
        root = tmp_path / tag
        monkeypatch.setenv("REPRO_CACHE_DIR", str(root))
        clear()
        cold = fn(graph, grid)
        assert cold.ok and not cold.stats.disk_cache_hit
        clear()
        warm = fn(graph, grid)
        assert warm.stats.disk_cache_hit and warm.stats.backend == "disk-cache"
        assert (warm.mapping.ii, warm.mapping.placement) == (
            cold.mapping.ii, cold.mapping.placement)
        layouts.append(sorted(_cache_files(root)))
    clear_mapping_cache()
    jclear_mapping_cache()
    assert layouts[0] == layouts[1] and len(layouts[0]) == 1


def test_map_dfg_keyword_checks():
    dfg, cgra = running_example(), CGRA(2, 2)
    for bad in ({"warp_factor": 9}, {"jobs": 4}, {"profile": "fast"}):
        with pytest.raises(TypeError):
            map_dfg(dfg, cgra, **bad)
    for bad in ({"connectivity": "loose"}, {"max_slack": -1},
                {"time_budget_s": 0}, {"space_backend": "greedy"}):
        with pytest.raises(ValueError):
            map_dfg(dfg, cgra, **bad)


class _FakeTerm:
    """A z3 term of the fake module below: its text and its context."""

    def __init__(self, ctx, text):
        self.ctx, self.text = ctx, text

    def _op(self, sym, other, flip=False):
        if isinstance(other, _FakeTerm):
            assert other.ctx is self.ctx, "terms of two contexts mixed"
        o = getattr(other, "text", str(other))
        lhs, rhs = (o, self.text) if flip else (self.text, o)
        return _FakeTerm(self.ctx, f"({lhs} {sym} {rhs})")

    def __ge__(self, o): return self._op(">=", o)
    def __le__(self, o): return self._op("<=", o)
    def __lt__(self, o): return self._op("<", o)
    def __eq__(self, o): return self._op("==", o)
    def __ne__(self, o): return self._op("!=", o)
    def __add__(self, o): return self._op("+", o)
    def __sub__(self, o): return self._op("-", o)
    def __mul__(self, o): return self._op("*", o)
    def __rmul__(self, o): return self._op("*", o, flip=True)

    __hash__ = object.__hash__


class _FakeZ3:
    """Just enough of z3's Python API to build the time encoding: it records
    every assertion and the context of every term, and answers unsat."""

    Z3Exception = RuntimeError
    sat, unsat = "sat", "unsat"

    def __init__(self):
        self.global_ctx = object()
        self.contexts, self.assertions = [], []

    def Context(self):
        self.contexts.append(object())
        return self.contexts[-1]

    def Int(self, name, ctx=None):
        return _FakeTerm(ctx or self.global_ctx, name)

    def _joined(self, name, terms):
        ctx = terms[0].ctx
        assert all(t.ctx is ctx for t in terms), "terms of two contexts mixed"
        return _FakeTerm(ctx, f"{name}({', '.join(t.text for t in terms)})")

    def PbLe(self, pairs, k):
        return self._joined(f"pb<={k}", [t for t, _ in pairs])

    def Or(self, *args):
        terms = list(args[0]) if len(args) == 1 else list(args)
        return self._joined("or", terms)

    def Solver(self, ctx=None):
        fake = self

        class _Solver:
            def __init__(self):
                self.ctx = ctx or fake.global_ctx

            def add(self, *terms):
                for t in terms:
                    assert t.ctx is self.ctx, "an assertion of another context"
                    fake.assertions.append(t.text)

            def set(self, *a):
                pass

            def check(self):
                return fake.unsat

        return _Solver()


def test_z3_backend_builds_in_a_context_of_its_own(monkeypatch):
    """The port's z3 time backend puts every term of a backend in a context
    of its own (z3 contexts are not thread-safe, and the daemon's worker
    threads solve at once), and asserts the reference's encoding term for
    term. A fake z3 module stands in for z3, which this host may lack."""
    from repro.core.time_backends import z3_backend as jz3_backend
    from repro_torch.core.time_backends import z3_backend
    from repro_torch.core.time_smt import TimeSolver

    dfg = load_suite(["gsm"])["gsm"]
    problem = TimeSolver(dfg, CGRA(4, 4), 4, backend="cp")._engine.p
    texts = []
    for module in (z3_backend, jz3_backend):
        fake = _FakeZ3()
        monkeypatch.setattr(module, "z3", fake)
        monkeypatch.setattr(module, "HAVE_Z3", True)
        first = module.Z3Backend(problem, timeout_s=1.0)
        second = module.Z3Backend(problem, timeout_s=1.0)
        assert first.next_solution() is None and first.exhausted
        texts.append((fake.assertions, fake.contexts, first, second))
    (mine, contexts, first, second), (ref, jcontexts, jfirst, _) = texts
    assert mine == ref and len(mine) > 2 * dfg.num_nodes
    assert len(contexts) == 2 and contexts[0] is not contexts[1]
    assert first._solver.ctx is contexts[0] and second._solver.ctx is contexts[1]
    assert all(t.ctx is contexts[0] for t in first._t + first._k + first._f)
    assert jcontexts == [] and jfirst._solver.ctx is not None   # the global one
