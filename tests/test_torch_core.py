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
from repro.core import running_example as jrunning_example
from repro.core.benchsuite import load_suite as jload_suite
from repro.core.benchsuite import route_stress_dfg as jroute_stress_dfg
from repro.core.dfg import splice_routes as jsplice_routes
from repro.core.simulate import check_equivalence as jcheck_equivalence
from repro.core.simulate import interpret_dfg as jinterpret_dfg
from repro.core.simulate import register_pressure_by_pe as jregister_pressure_by_pe
from repro.core.time_backends import BackendUnavailable as JBackendUnavailable
from repro.core.time_backends import available_backends as javailable_backends
from repro_torch.core import CGRA, DFG, map_dfg, running_example
from repro_torch.core.benchsuite import TABLE3_BENCHMARKS, load_suite, route_stress_dfg
from repro_torch.core.dfg import splice_routes
from repro_torch.core.simulate import (
    check_equivalence,
    interpret_dfg,
    register_pressure_by_pe,
)
from repro_torch.core.space_backends import SpaceBackendNotPorted
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


def test_unported_backends_raise():
    dfg, cgra = running_example(), CGRA(2, 2)
    # z3 is registered as in the reference, which is where its absence shows
    assert available_backends() == javailable_backends() == {"cp": True, "z3": False}
    with pytest.raises(BackendUnavailable, match="^time backend 'z3' is not importable$"):
        map_dfg(dfg, cgra, backend="z3")
    with pytest.raises(JBackendUnavailable, match="^time backend 'z3' is not importable$"):
        jmap_dfg(jrunning_example(), JCGRA(2, 2), backend="z3")
    with pytest.raises(SpaceBackendNotPorted, match="not ported"):
        map_dfg(dfg, cgra, space_backend="anneal")
    with pytest.raises(SpaceBackendNotPorted):
        map_dfg(dfg, CGRA(21, 20))          # auto above 400 PEs
    with pytest.raises(NotImplementedError, match="cache"):
        map_dfg(dfg, cgra, cache_dir="somewhere")


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


def test_cache_dir_from_environment_raises(monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", "somewhere")
    with pytest.raises(NotImplementedError, match="REPRO_CACHE_DIR"):
        map_dfg(running_example(), CGRA(2, 2))


def test_map_dfg_keyword_checks():
    dfg, cgra = running_example(), CGRA(2, 2)
    for bad in ({"warp_factor": 9}, {"jobs": 4}, {"profile": "fast"}):
        with pytest.raises(TypeError):
            map_dfg(dfg, cgra, **bad)
    for bad in ({"connectivity": "loose"}, {"max_slack": -1},
                {"time_budget_s": 0}, {"space_backend": "greedy"}):
        with pytest.raises(ValueError):
            map_dfg(dfg, cgra, **bad)
