"""The port's architecture presets and annealing engine against the JAX
package's, on the CPU.

``repro_torch.core.arch`` and ``core/space_backends/anneal.py`` are copies
of the reference's modules (tests/test_torch_copies.py pins the source).
Here they are held to the reference on the same inputs, with exact
equality throughout: a preset's JSON and spec hash, a deterministic mapping
(ii, t_abs, placement) on the heterogeneous presets and on a 50×50 fabric,
and the trace of the port's ``cgra_run(device="cpu")`` against the JAX
package's oracle ``cgra_sim_reference`` on the reference's own program.
"""

import numpy as np
import pytest

from repro.core import CGRA as JCGRA
from repro.core import map_dfg as jmap_dfg
from repro.core.arch import get_preset as jget_preset
from repro.core.arch import list_presets as jlist_presets
from repro.core.arch import resolve_arch as jresolve_arch
from repro.core.benchsuite import load_suite as jload_suite
from repro.core.frontend import trace_loop
from repro.core.space_backends import resolve_space_backend_name as jresolve_name
from repro.kernels.ops import compile_program as jcompile_program
from repro.kernels.ref import cgra_sim_reference as jcgra_sim_reference
from repro_torch.core import CGRA, DFG, ArchSpec, get_preset, list_presets, map_dfg, resolve_arch
from repro_torch.core.benchsuite import load_suite
from repro_torch.core.cgra import op_class
from repro_torch.core.simulate import check_equivalence
from repro_torch.core.space_backends import resolve_space_backend_name
from repro_torch.kernels.ops import cgra_run, compile_program
from repro_torch.kernels.ref import cgra_sim_reference


def _key(mapping):
    return mapping.ii, mapping.t_abs, mapping.placement


def test_preset_list_matches_reference():
    assert list_presets() == jlist_presets()


@pytest.mark.parametrize("name", jlist_presets())
def test_preset_json_and_hash_match_reference(name):
    mine, ref = get_preset(name), jget_preset(name)
    assert mine.to_json() == ref.to_json()
    assert mine.spec_hash() == ref.spec_hash()
    assert ArchSpec.from_json(ref.to_json()) == mine
    cgra, jcgra = mine.cgra(), ref.cgra()
    assert (cgra.rows, cgra.cols, cgra.topology, cgra.arch_token()) == (
        jcgra.rows, jcgra.cols, jcgra.topology, jcgra.arch_token())


def test_resolve_arch_by_name_and_by_json_path(tmp_path):
    path = tmp_path / "edge.json"
    jget_preset("satmapit_edge_mem_4x4").save(str(path))
    for arg in ("satmapit_edge_mem_4x4", str(path)):
        mine, ref = resolve_arch(arg), jresolve_arch(arg)
        assert mine.to_json() == ref.to_json()
    with pytest.raises(ValueError):
        resolve_arch("no_such_preset")


def _mac_body(ins, carried):
    acc = carried["acc"] + ins[0] * ins[1]
    return [acc], {"acc": acc}


def _prods_body(ins, carried):
    prod = ins[0] * ins[1] * ins[2]     # two muls: diagonal PEs only
    acc = carried["acc"] + prod
    return [acc], {"acc": acc}


# the DFGs of tests/test_arch.py's trace/map/execute cases, traced by the
# reference frontend and carried over as JSON
HETERO = {
    "satmapit_edge_mem_4x4": (_mac_body, 2, "mac"),
    "mul_sparse_8x8": (_prods_body, 3, "prods"),
}


@pytest.mark.parametrize("preset", sorted(HETERO))
def test_hetero_preset_mapping_and_execution_match_reference(preset):
    body, num_inputs, name = HETERO[preset]
    jdfg = trace_loop(body, num_inputs=num_inputs, carried=["acc"], name=name)
    dfg = DFG.from_json(jdfg.to_json())
    cgra, jcgra = get_preset(preset).cgra(), jget_preset(preset).cgra()
    mine = map_dfg(dfg, cgra, deterministic=True, use_cache=False)
    ref = jmap_dfg(jdfg, jcgra, deterministic=True, use_cache=False)
    assert mine.ok and ref.ok, (mine.reason, ref.reason)
    assert _key(mine.mapping) == _key(ref.mapping)
    for v in dfg.nodes:
        assert cgra.capable(mine.mapping.placement[v], op_class(dfg.ops[v]))
    check_equivalence(mine.mapping)
    num_iters, batch = 6, 16
    prog = compile_program(mine.mapping)
    rng = np.random.default_rng(0)
    inputs = {v: rng.uniform(-4, 4, (num_iters, batch)).astype(np.float32).round(2)
              for v in prog.input_nodes()}
    outs, trace = cgra_run(prog, inputs, num_iters, device="cpu")
    ref_outs, ref_trace = jcgra_sim_reference(
        jcompile_program(ref.mapping), inputs, num_iters)
    np.testing.assert_array_equal(trace.numpy(), ref_trace)
    np.testing.assert_array_equal(cgra_sim_reference(prog, inputs, num_iters)[1], ref_trace)
    assert sorted(outs) == sorted(ref_outs)
    for v in outs:
        np.testing.assert_array_equal(outs[v].numpy(), ref_outs[v])


def test_deterministic_anneal_50x50_matches_reference():
    """The annealing engine seeds ``random.Random`` from the options' seed;
    the copy keeps every iteration order, so the placement is the
    reference's exactly."""
    kw = dict(deterministic=True, use_cache=False, space_backend="anneal", seed=3)
    mine = map_dfg(load_suite(["backprop"])["backprop"], CGRA(50, 50), **kw)
    ref = jmap_dfg(jload_suite(["backprop"])["backprop"], JCGRA(50, 50), **kw)
    assert mine.ok and ref.ok
    assert mine.stats.space_backend == ref.stats.space_backend == "anneal"
    assert _key(mine.mapping) == _key(ref.mapping)
    assert mine.mapping.validate() == []
    for f in ("rounds", "windows_opened", "time_solutions_tried",
              "mono_failures", "space_nodes_visited", "space_restarts"):
        assert getattr(mine.stats, f) == getattr(ref.stats, f), f


def test_auto_resolves_to_anneal_above_400_pes_in_both_packages():
    """Above 400 PEs the reference's auto takes anneal everywhere; the port's
    takes the window engine on a homogeneous mesh (the exact engine on a
    centred 400-PE sub-mesh first) and anneal on every other fabric, where
    its mapping stays the reference's."""
    assert jresolve_name("auto", JCGRA(21, 21)) == "anneal"
    assert resolve_space_backend_name("auto", CGRA(21, 21)) == "window"
    assert resolve_space_backend_name("auto", get_preset("mesh_50x50").cgra()) == "window"
    kw = dict(deterministic=True, use_cache=False, seed=1)
    mine = map_dfg(load_suite(["bitcount"])["bitcount"], CGRA(21, 21), **kw)
    ref = jmap_dfg(jload_suite(["bitcount"])["bitcount"], JCGRA(21, 21), **kw)
    assert mine.ok and ref.ok and ref.stats.space_backend == "anneal"
    assert mine.stats.space_backend == "window" and mine.mapping.validate() == []
    assert mine.mapping.ii <= ref.mapping.ii
    for topology in ("torus", "diagonal"):
        assert resolve_space_backend_name("auto", CGRA(21, 21, topology=topology)) == "anneal"
        mine = map_dfg(load_suite(["bitcount"])["bitcount"],
                       CGRA(21, 21, topology=topology), **kw)
        ref = jmap_dfg(jload_suite(["bitcount"])["bitcount"],
                       JCGRA(21, 21, topology=topology), **kw)
        assert mine.ok and mine.stats.space_backend == ref.stats.space_backend == "anneal"
        assert _key(mine.mapping) == _key(ref.mapping)
