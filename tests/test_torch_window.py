"""The window engine, which the port's ``auto`` takes on a homogeneous mesh of
more than 400 PEs: the exact engine on the centred 400-PE sub-mesh, then
anneal on the whole fabric (core/space_backends/window.py), on the CPU.

Its mappings are held to the benchmark's own checker and interpreter
(``perfbench/legality.py``, ``perfbench/reference.py``), which share no code
with the port, and to what the exact engine reaches on a 20x20 mesh."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

from repro.core import CGRA as JCGRA
from repro.core import map_dfg as jmap_dfg
from repro.core.dfg import DFG as JDFG
from repro_torch import obs
from repro_torch.core import CGRA, DFG, Edge, map_dfg
from repro_torch.core.benchsuite import load_suite
from repro_torch.core.fuzz import random_dfg
from repro_torch.core.space_backends import (
    ExactSpaceBackend,
    SpaceBudget,
    SpaceStats,
    WindowSpaceBackend,
    check_monomorphism,
    resolve_space_backend_name,
    window_of,
)
from repro_torch.kernels.ops import cgra_run, compile_program

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import legality, reference  # noqa: E402

DET = dict(deterministic=True, use_cache=False)
SPACE_OUTCOMES = {"found", "exhausted", "node_budget", "timeout", "cancelled"}
# a random DFG of the size tests/test_theorem.py draws (6 to 18 nodes): 15
# nodes, two loop-carried edges, a store
RANDOM = "random-5"


def _dfg(name: str) -> DFG:
    if name == RANDOM:
        return random_dfg(5, min_nodes=6, max_nodes=18, name=RANDOM)
    return load_suite([name])[name]


def _key(mapping) -> tuple:
    return mapping.ii, tuple(mapping.t_abs), tuple(mapping.placement)


def _moved_pes(pes, cgra: CGRA) -> list[int]:
    """PEs of the fabric's window, in the fabric's PE ids."""
    window, r0, c0 = window_of(cgra)
    return [(p // window.cols + r0) * cgra.cols + p % window.cols + c0 for p in pes]


def _moved(mapping, cgra: CGRA) -> list[int]:
    """A placement on the fabric's window, in the fabric's PE ids."""
    return _moved_pes(mapping.placement, cgra)


@pytest.mark.parametrize("shape, want", [
    ((50, 50), (20, 20, 15, 15)),
    ((21, 20), (20, 20, 0, 0)),
    ((20, 21), (20, 20, 0, 0)),
    ((200, 3), (133, 3, 33, 0)),
])
def test_the_window_is_the_centred_sub_mesh(shape, want):
    cgra = CGRA(*shape, registers_per_pe=6)
    window, r0, c0 = window_of(cgra)
    assert (window.rows, window.cols, r0, c0) == want
    assert window.num_pes <= 400 and window == CGRA(want[0], want[1], registers_per_pe=6)


def test_auto_takes_the_window_on_large_homogeneous_meshes_only():
    assert resolve_space_backend_name("auto", CGRA(20, 20)) == "exact"
    assert resolve_space_backend_name("auto", CGRA(4, 4)) == "exact"
    assert resolve_space_backend_name("auto", CGRA(21, 20)) == "window"
    assert resolve_space_backend_name("auto", CGRA(50, 50)) == "window"
    for topology in ("torus", "diagonal", "one-hop"):
        assert resolve_space_backend_name("auto", CGRA(21, 20, topology=topology)) == "anneal"
    classes = tuple(("alu", "mem") if p % 2 else ("alu", "mem", "mul") for p in range(420))
    assert resolve_space_backend_name("auto", CGRA(21, 20, pe_classes=classes)) == "anneal"
    # the named engines stay what they are at any size
    for name in ("exact", "anneal"):
        assert resolve_space_backend_name(name, CGRA(50, 50)) == name
    # the options take no "window": auto alone reaches the engine, which
    # refuses a fabric without a sound window
    dfg = load_suite(["gsm"])["gsm"]
    with pytest.raises(ValueError, match="space_backend must be one of"):
        map_dfg(dfg, CGRA(50, 50), space_backend="window", **DET)
    for cgra in (CGRA(20, 20), CGRA(21, 20, topology="torus"), CGRA(21, 20, pe_classes=classes)):
        with pytest.raises(ValueError, match="homogeneous mesh of more than 400 PEs"):
            WindowSpaceBackend().place(dfg, cgra, [0] * dfg.num_nodes, 9)


@pytest.mark.parametrize("name", ["bitcount", "fft", "gsm", RANDOM])
@pytest.mark.parametrize("shape", [(21, 20), (50, 50)])
def test_auto_maps_a_large_mesh_legally_and_no_worse_than_20x20(shape, name):
    dfg, cgra = _dfg(name), CGRA(*shape)
    res = map_dfg(dfg, cgra, **DET)
    small = map_dfg(dfg, CGRA(20, 20), space_backend="exact", **DET)
    assert res.ok and small.ok
    assert res.stats.space_backend == "window"
    assert res.mapping.ii <= small.mapping.ii
    assert _key(map_dfg(dfg, cgra, **DET).mapping) == _key(res.mapping)
    plain = reference.PlainDFG.from_json(dfg.to_json())
    mesh = legality.Mesh(*shape)
    assert legality.violations(plain, mesh, res.mapping.ii, res.mapping.t_abs,
                               res.mapping.placement) == []
    # the stores the executor computes are the plain interpreter's
    prog = compile_program(res.mapping)
    rng = np.random.default_rng(3)
    num_iters, batch = 5, 7
    inputs = {v: np.round(rng.uniform(-4, 4, (num_iters, batch)), 2).astype(np.float32)
              for v in prog.input_nodes()}
    outs, _ = cgra_run(prog, inputs, num_iters, device="cpu")
    want = reference.interpret(plain, inputs, num_iters)
    stores = {v: out.numpy() for v, out in outs.items()}
    assert sorted(want) and reference.mismatches(stores, want) == 0


@pytest.mark.parametrize("name", ["bitcount", "fft", "gsm"])
def test_on_50x50_the_window_repeats_the_20x20_search(name):
    """Where the window finds every placement the search needs, the 50x50
    mapping is the exact engine's 20x20 mapping, moved to the centre."""
    dfg, cgra = _dfg(name), CGRA(50, 50)
    res = map_dfg(dfg, cgra, **DET)
    small = map_dfg(dfg, CGRA(20, 20), **DET)
    assert small.stats.space_backend == "exact"
    assert res.mapping.ii == small.mapping.ii
    assert res.mapping.t_abs == small.mapping.t_abs
    assert res.mapping.placement == _moved(small.mapping, cgra)
    for f in ("rounds", "windows_opened", "mono_failures", "space_nodes_visited"):
        assert getattr(res.stats, f) == getattr(small.stats, f), f


def test_the_fabric_takes_over_where_the_window_cannot():
    """401 ops at one step cannot fit the 400-PE window: its search ends
    exhausted at once, and anneal places them on the 420-PE fabric."""
    n = 401
    dfg = DFG(num_nodes=n, ops=["add"] * n, edges=[], name="wide")
    cgra = CGRA(21, 20)
    stats = SpaceStats()
    with obs.tracing() as tracer:
        sol = WindowSpaceBackend().place(dfg, cgra, [0] * n, 1, stats=stats, seed=0,
                                         budget=SpaceBudget(timeout_s=None, node_budget=50_000))
    assert sol is not None and stats.region == "fabric"
    assert check_monomorphism(dfg, cgra, [0] * n, sol.placement, 1) == []
    (window,) = [e for e in tracer.events if e["name"] == "space.window"]
    assert window["args"] == {"pes": 400, "ii": 1, "outcome": "exhausted"}


def test_route_throughs_found_in_the_window_land_on_the_fabric():
    """A hub with six neighbours at one step has no direct embedding on a
    mesh (five PEs in a closed neighbourhood); one hop of route-through
    places it. The window's movs land on the fabric's PEs, each chain through
    adjacent ones, as the 20x20 search placed them."""
    n = 7
    dfg = DFG(num_nodes=n, ops=["add"] * n, edges=[Edge(0, v) for v in range(1, n)],
              name="hub")
    labels, t_abs = [0] + [1] * 6, [0] + [3] * 6
    budget = SpaceBudget(timeout_s=None, node_budget=100_000)
    cgra = CGRA(50, 50)
    kw = dict(budget=budget, t_abs=t_abs, max_route_hops=1)
    assert ExactSpaceBackend().place(dfg, CGRA(20, 20), labels, 2, budget=budget) is None
    small = ExactSpaceBackend().place(dfg, CGRA(20, 20), labels, 2, **kw)
    stats = SpaceStats()
    sol = WindowSpaceBackend().place(dfg, cgra, labels, 2, stats=stats, **kw)
    assert small.routes and sol is not None and stats.region == "window"
    assert sol.placement == _moved(small, cgra)
    assert [r.path for r in sol.routes] == [tuple(_moved_pes(r.path, cgra)) for r in small.routes]
    for r in sol.routes:
        chain = (sol.placement[r.edge[0]], *r.path, sol.placement[r.edge[1]])
        assert all(cgra.adjacency[a][b] for a, b in zip(chain, chain[1:]))
    assert [r.times for r in sol.routes] == [r.times for r in small.routes]


@pytest.mark.parametrize("shape, region, windows", [((50, 50), "window", True),
                                                    ((20, 20), "fabric", False)])
def test_traced_probes_say_where_the_placement_came_from(shape, region, windows):
    dfg = load_suite(["gsm"])["gsm"]
    plain = map_dfg(dfg, CGRA(*shape), **DET)
    with obs.tracing() as tracer:
        traced = map_dfg(dfg, CGRA(*shape), **DET)
    assert _key(traced.mapping) == _key(plain.mapping)
    probes = [e["args"] for e in tracer.events if e["name"] == "space.probe"]
    assert probes and probes[-1]["outcome"] == "found"
    for p in probes:
        assert p["region"] == (region if p["outcome"] == "found" else "")
    spans = [e["args"] for e in tracer.events if e["name"] == "space.window"]
    assert bool(spans) == windows
    for s in spans:
        assert s["pes"] == 400 and s["outcome"] in SPACE_OUTCOMES
    assert {s["ii"] for s in spans} <= {p["ii"] for p in probes}


@pytest.mark.parametrize("engine, shape", [
    ("auto", (4, 4)), ("auto", (20, 20)), ("exact", (21, 20)), ("anneal", (21, 20)),
])
@pytest.mark.parametrize("name", ["fft", RANDOM])
def test_auto_up_to_400_pes_and_the_named_engines_are_the_references(engine, shape, name):
    dfg = _dfg(name)
    mine = map_dfg(dfg, CGRA(*shape), space_backend=engine, seed=2, **DET)
    ref = jmap_dfg(JDFG.from_json(dfg.to_json()), JCGRA(*shape), space_backend=engine,
                   seed=2, **DET)
    assert mine.ok and ref.ok
    assert mine.stats.space_backend == ref.stats.space_backend
    assert _key(mine.mapping) == _key(ref.mapping)
    for f in ("rounds", "windows_opened", "mono_failures", "space_nodes_visited"):
        assert getattr(mine.stats, f) == getattr(ref.stats, f), f
