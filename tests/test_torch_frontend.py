"""The port's tracing frontend and stage placement against the JAX package's.

``repro_torch.core.frontend`` and ``repro_torch.core.placement`` are copies
of the reference's modules. The scenarios of ``tests/test_frontend.py`` and
the placement checks of ``tests/test_roofline_and_dryrun.py`` run against the
port; both ``trace_loop``s give equal DFGs on the same loop bodies, both
``place_stages`` give equal placements on the same stage graphs, and
``examples/pipeline_placement_torch.py`` prints what the reference example
prints. A traced multiply-accumulate runs through the port's executor on the
CPU and equals a numpy running sum.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import repro.core.frontend as jfrontend
import repro.core.placement as jplacement
import repro_torch.core.placement as placement_mod
from repro_torch.core import CGRA, map_dfg
from repro_torch.core.frontend import trace_loop
from repro_torch.core.placement import (
    device_order_for_pipeline,
    expert_groups_graph,
    linear_pipeline,
    place_stages,
)
from repro_torch.core.simulate import check_equivalence, interpret_dfg
from repro_torch.kernels.ops import cgra_run, compile_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mac_body(ins, carried):
    acc = carried["acc"] + ins[0] * ins[1]
    return [acc], {"acc": acc}


def mixed_body(ins, carried):
    x = (ins[0] + 2.0) * ins[1] - 1.0
    y = abs(-x).min(100.0)
    return [y], {}


def all_ops_body(ins, carried):
    """Every operator ``Var`` overloads, with a carried accumulator."""
    a, b, c = ins
    s = a + b
    d = 1.5 - a
    e = 2.0 + b
    f = 3.0 * c
    h = (s * d) / (abs(e) + 1.0)
    i = (s & 255.0) | (b ^ c)
    j = (i << 2.0) >> (a - 1.0)
    k = -(~j)
    n = k.min(h).max(f > h)
    acc = carried["acc"] + n - f
    return [acc, j], {"acc": acc}


BODIES = {
    "mac": (mac_body, 2, ["acc"]),
    "mixed": (mixed_body, 2, []),
    "all_ops": (all_ops_body, 3, ["acc"]),
}


# ------------------------------------------- tests/test_frontend.py's scenarios

def test_trace_mac_loop_maps_and_executes():
    dfg = trace_loop(mac_body, num_inputs=2, carried=["acc"], name="mac")
    assert dfg.ops.count("store") == 1
    assert dfg.carried_edges()
    res = map_dfg(dfg, CGRA(2, 2), time_budget_s=20)
    assert res.ok
    check_equivalence(res.mapping, num_iters=6)


def test_trace_semantics_mac():
    """The traced MAC must actually accumulate across iterations."""
    dfg = trace_loop(mac_body, num_inputs=2, carried=["acc"])
    a = [1.0, 2.0, 3.0]
    b = [10.0, 10.0, 10.0]
    inputs = {v: (a if i == 0 else b) for i, v in enumerate(
        [n for n in dfg.nodes if dfg.ops[n] == "input"])}
    outs = interpret_dfg(dfg, inputs, 3)
    assert next(iter(outs.values())) == [10.0, 30.0, 60.0]


def test_trace_mixed_ops_and_constants():
    dfg = trace_loop(mixed_body, num_inputs=2)
    res = map_dfg(dfg, CGRA(3, 3), time_budget_s=20)
    assert res.ok
    check_equivalence(res.mapping, num_iters=4)


def test_trace_rejects_bad_carried():
    with pytest.raises(ValueError):
        trace_loop(lambda ins, c: ([ins[0]], {"other": ins[0]}),
                   num_inputs=1, carried=["acc"])


def test_expert_group_placement_single_hop():
    g = expert_groups_graph(16, heavy_routes=[(0, 5), (2, 9), (7, 12)])
    placement = place_stages(g, (4, 4))
    assert placement is not None
    assert placement.single_hop_fraction() == 1.0
    assert len(set(placement.stage_to_device)) == 16


# --------------------------- tests/test_roofline_and_dryrun.py's placement checks

def test_placement_single_hop():
    placement = place_stages(linear_pipeline(8), (4, 4))
    assert placement is not None
    assert placement.ii == 1                      # fully spatial pipeline
    assert placement.single_hop_fraction() == 1.0
    assert len(set(placement.stage_to_device)) == 8


def test_placement_device_order():
    order = device_order_for_pipeline(16, (4, 4))
    assert sorted(order) == list(range(16))       # a Hamiltonian ordering


# ------------------------------------------------ parity with the reference

@pytest.mark.parametrize("body", sorted(BODIES))
def test_trace_loop_matches_reference(body):
    fn, num_inputs, carried = BODIES[body]
    mine = trace_loop(fn, num_inputs=num_inputs, carried=carried, name=body)
    # a loop body only sees ``Var`` operators: the same function traces
    # through either package
    ref = jfrontend.trace_loop(fn, num_inputs=num_inputs, carried=carried, name=body)
    assert mine.to_json() == ref.to_json()
    assert mine.stable_hash() == ref.stable_hash()


def test_all_ops_body_covers_every_overload():
    dfg = trace_loop(all_ops_body, num_inputs=3, carried=["acc"])
    overloaded = {"add", "sub", "mul", "div", "and", "or", "xor", "shl", "shr",
                  "neg", "not", "abs", "cmp", "min", "max", "const"}
    assert overloaded <= set(dfg.ops)


def test_trace_rejects_foreign_vars_like_reference():
    other = []
    trace_loop(lambda ins, c: (other.append(ins[0]) or [ins[0]], {}), num_inputs=1)
    with pytest.raises(TypeError, match="same trace"):
        trace_loop(lambda ins, c: ([ins[0] + other[0]], {}), num_inputs=1)
    with pytest.raises(TypeError, match="must be a Var"):
        trace_loop(lambda ins, c: ([ins[0]], {"acc": 1.0}), num_inputs=1,
                   carried=["acc"])
    with pytest.raises(TypeError, match="must be a Var"):
        jfrontend.trace_loop(lambda ins, c: ([ins[0]], {"acc": 1.0}), num_inputs=1,
                             carried=["acc"])


def test_traced_mac_runs_a_running_sum():
    """The mapping computes the traced function: the stores of the MAC loop
    equal a numpy running sum of a*b in f32."""
    dfg = trace_loop(mac_body, num_inputs=2, carried=["acc"], name="mac")
    res = map_dfg(dfg, CGRA(3, 3), deterministic=True)
    assert res.ok, res.reason
    prog = compile_program(res.mapping)
    rng = np.random.default_rng(0)
    a_node, b_node = [v for v in dfg.nodes if dfg.ops[v] == "input"]
    inputs = {v: rng.uniform(-4, 4, (16, 64)).astype(np.float32).round(2)
              for v in prog.input_nodes()}
    outs, _ = cgra_run(prog, inputs, 16, device="cpu")
    (store,) = outs.values()
    want = np.cumsum(inputs[a_node] * inputs[b_node], axis=0, dtype=np.float32)
    np.testing.assert_allclose(store.numpy(), want, rtol=1e-5, atol=0)


def _view(p):
    return (p.mesh_shape, p.stage_to_device, p.stage_phase, p.ii,
            p.single_hop_fraction(), p.permute_pairs(),
            p.mapping.t_abs, p.mapping.placement)


GRAPHS = {
    "pipe8_4x4": (lambda m: m.linear_pipeline(8), (4, 4)),
    "pipe16_4x4": (lambda m: m.linear_pipeline(16), (4, 4)),
    "pipe12_4x8": (lambda m: m.linear_pipeline(12), (4, 8)),
    "pipe20_4x4": (lambda m: m.linear_pipeline(20), (4, 4)),
    "pipe6_nowrap_3x3": (lambda m: m.linear_pipeline(6, wrap=False), (3, 3)),
    "experts16_hot3": (lambda m: m.expert_groups_graph(
        16, heavy_routes=[(0, 5), (2, 9), (7, 12)]), (4, 4)),
    "experts16_hot4": (lambda m: m.expert_groups_graph(
        16, heavy_routes=[(0, 5), (2, 9), (7, 12), (3, 14)], name="moe_ep"), (4, 4)),
    "experts8_dupes": (lambda m: m.expert_groups_graph(
        8, heavy_routes=[(5, 0), (0, 5), (3, 3)]), (2, 4)),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_place_stages_matches_reference(graph):
    make, mesh = GRAPHS[graph]
    stages, jstages = make(placement_mod), make(jplacement)
    assert stages.flows == jstages.flows
    assert stages.to_dfg().to_json() == jstages.to_dfg().to_json()
    mine, ref = place_stages(stages, mesh), jplacement.place_stages(jstages, mesh)
    assert mine is not None and ref is not None
    assert _view(mine) == _view(ref)


@pytest.mark.parametrize("stages,mesh", [(16, (4, 4)), (8, (4, 4)), (9, (3, 3)),
                                         (20, (4, 4))])
def test_device_order_matches_reference(stages, mesh):
    assert device_order_for_pipeline(stages, mesh) == (
        jplacement.device_order_for_pipeline(stages, mesh))


def test_snake_fallback_matches_reference(monkeypatch):
    monkeypatch.setattr(placement_mod, "place_stages", lambda *a, **k: None)
    monkeypatch.setattr(jplacement, "place_stages", lambda *a, **k: None)
    for stages, mesh in [(16, (4, 4)), (7, (3, 4))]:
        order = device_order_for_pipeline(stages, mesh)
        assert order == jplacement.device_order_for_pipeline(stages, mesh)
    assert device_order_for_pipeline(7, (3, 4)) == [0, 1, 2, 3, 7, 6, 5]


def test_example_twin_prints_what_the_reference_prints():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def run(name):
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", name)],
                              env=env, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout.splitlines()

    mine, ref = run("pipeline_placement_torch.py"), run("pipeline_placement.py")
    # the one line that says where to feed the device order names each
    # framework's own mesh
    advice = [i for i, line in enumerate(ref) if line.startswith("(feed this to")]
    assert len(advice) == 1 and mine[advice[0]].startswith("(feed this to")
    assert "DeviceMesh" in mine[advice[0]]
    del mine[advice[0]], ref[advice[0]]
    assert mine == ref
    assert len(mine) == 8
