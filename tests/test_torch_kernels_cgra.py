"""The port's lowering and executor against the JAX package's, on the CPU.

Each case is mapped by the JAX package and carried across as plain data
(``repro_torch.interop``), so both lowerings see the same mapping. The
port's tables must equal the reference's array for array, and its traces
must equal the JAX oracle ``cgra_sim_reference`` exactly, and the Pallas
kernel (interpret mode) exactly in the tests' uniform(-4, 4) range. The CUDA
kernel itself runs only on a GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""

import json

import numpy as np
import pytest
import torch

from repro.core import CGRA as JCGRA
from repro.core import map_dfg as jmap_dfg
from repro.core import running_example as jrunning_example
from repro.core.arch import get_preset
from repro.core.benchsuite import route_stress_dfg as jroute_stress_dfg
from repro.core.dfg import OP_ARITY
from repro.core.dfg import DFG as JDFG
from repro.core.dfg import Edge as JEdge
from repro.core.simulate import interpret_dfg as jinterpret_dfg
from repro.kernels.ops import build_injection as jbuild_injection
from repro.kernels.ops import cgra_run as jcgra_run
from repro.kernels.ops import compile_program as jcompile_program
from repro.kernels.ref import cgra_sim_reference as jcgra_sim_reference
from repro_torch import obs
from repro_torch.interop import mapping_from_plain, plain_mapping
from repro_torch.kernels import ops
from repro_torch.kernels.cgra_sim import NOPS, SimTables, cgra_sim, cgra_sim_torch
from repro_torch.kernels.cgra_sim import _mask16 as torch_mask16
from repro_torch.kernels.ops import build_injection, cgra_run, compile_program
from repro_torch.kernels.ref import _mask16 as ref_mask16
from repro_torch.kernels.ref import cgra_sim_reference

_ONE_HOT = ("route_a", "route_b", "op_sel")      # the port derives these in _one_hot
_GRIDS = ("imm", "op_id", "node_at", "src_pe", "src_delta")


def _one_hot(prog):
    """The reference's one-hot routing and opcode tables, made from the
    port's grids: operand slot s of the node at (k, pe) reads ring slot
    delta - 1 of PE src_pe."""
    ii, pes = prog.op_id.shape
    route = np.zeros((2, ii, pes, prog.ring * pes), np.float32)
    op_sel = np.zeros((ii, pes, NOPS), np.float32)
    k, pe = np.nonzero(prog.op_id >= 0)
    op_sel[k, pe, prog.op_id[k, pe]] = 1.0
    k, pe, s = np.nonzero(prog.src_pe >= 0)
    route[s, k, pe, (prog.src_delta[k, pe, s] - 1) * pes + prog.src_pe[k, pe, s]] = 1.0
    return {"route_a": route[0], "route_b": route[1], "op_sel": op_sel}


def _opcover():
    """Every opcode (tests/test_kernels_cgra.py::test_all_float_ops_covered)."""
    mid = ["add", "sub", "mul", "div", "min", "max", "neg", "abs", "mov",
           "cmp", "and", "or", "xor", "shl", "shr", "not"]
    ops = ["input", "input", "const"] + mid + ["store"]
    edges, prev = [], 2
    for v in range(3, 3 + len(mid)):
        edges.append(JEdge(prev, v))
        if OP_ARITY[ops[v]] == 2:
            edges.append(JEdge(v % 2, v))
        prev = v
    edges.append(JEdge(prev, len(ops) - 1))
    return JDFG(num_nodes=len(ops), edges=edges, ops=ops, imms=[0, 0, 1.5] + [0] * 17,
                name="opcover")


def _accum():
    return JDFG(num_nodes=4, edges=[JEdge(0, 1), JEdge(1, 2), JEdge(2, 1, 1), JEdge(2, 3)],
                ops=["input", "phi", "mov", "store"], name="accum")


def _overflow():
    return JDFG(num_nodes=4, edges=[JEdge(0, 2), JEdge(1, 2), JEdge(2, 3)],
                ops=["input", "input", "add", "store"], name="overflow")


# name -> (dfg, cgra, map keywords, num_iters, batch): the cases of
# tests/test_kernels_cgra.py and the routed mapping of tests/test_route_through.py
CASES = {
    "running_example_2x2_b8": (jrunning_example, lambda: JCGRA(2, 2), {}, 5, 8),
    "running_example_2x2_b32": (jrunning_example, lambda: JCGRA(2, 2), {}, 5, 32),
    "running_example_2x2_b128": (jrunning_example, lambda: JCGRA(2, 2), {}, 5, 128),
    "running_example_3x3": (jrunning_example, lambda: JCGRA(3, 3), {}, 4, 8),
    "running_example_4x4": (jrunning_example, lambda: JCGRA(4, 4), {}, 4, 8),
    "opcover_3x3": (_opcover, lambda: JCGRA(3, 3), {}, 3, 8),
    "accum_2x2": (_accum, lambda: JCGRA(2, 2), {}, 6, 8),
    "onehop_split_4x4": (jroute_stress_dfg,
                         lambda: get_preset("onehop_split_4x4").cgra(),
                         {"max_route_hops": 2, "max_ii": 6}, 5, 8),
}

_PROGRAMS = {}


def _case(name):
    """(JAX program, port program, num_iters, batch), mapped once per name."""
    if name not in _PROGRAMS:
        make_dfg, make_cgra, kw, num_iters, batch = CASES[name]
        res = jmap_dfg(make_dfg(), make_cgra(), deterministic=True, **kw)
        assert res.ok, res.reason
        jprog = jcompile_program(res.mapping)
        # through JSON: the plain data is what a file or a socket would carry
        plain = json.loads(json.dumps(plain_mapping(res.mapping)))
        prog = compile_program(mapping_from_plain(plain))
        _PROGRAMS[name] = (jprog, prog, num_iters, batch)
    return _PROGRAMS[name]


def _inputs(prog, num_iters, batch, seed=0):
    rng = np.random.default_rng(seed)
    return {v: rng.uniform(-4, 4, (num_iters, batch)).astype(np.float32).round(2)
            for v in prog.input_nodes()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lowering_matches_reference(name):
    jprog, prog, num_iters, batch = _case(name)
    assert (prog.ii, prog.ring, prog.num_pes) == (jprog.ii, jprog.ring, jprog.num_pes)
    mine = {**_one_hot(prog), **{f: getattr(prog, f) for f in _GRIDS}}
    for f in _ONE_HOT + _GRIDS:
        a, b = mine[f], getattr(jprog, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    inputs = _inputs(prog, num_iters, batch)
    for a, b in zip(build_injection(prog, inputs, num_iters),
                    jbuild_injection(jprog, inputs, num_iters)):
        assert np.array_equal(a, b)
    if name == "onehop_split_4x4":
        assert prog.mapping.routes, "the case must exercise route-through movs"


@pytest.mark.parametrize("name", sorted(CASES))
def test_cgra_run_matches_reference_exactly(name):
    jprog, prog, num_iters, batch = _case(name)
    inputs = _inputs(prog, num_iters, batch)
    outs, trace = cgra_run(prog, inputs, num_iters, device="cpu")
    assert trace.device.type == "cpu" and trace.dtype == torch.float32
    ref_outs, ref_trace = jcgra_sim_reference(jprog, inputs, num_iters)
    np.testing.assert_array_equal(trace.numpy(), ref_trace)
    assert sorted(outs) == sorted(ref_outs)
    for v in outs:
        np.testing.assert_array_equal(outs[v].numpy(), ref_outs[v])
    # the port's own oracle is the same function
    np.testing.assert_array_equal(cgra_sim_reference(prog, inputs, num_iters)[1], ref_trace)
    # the Pallas kernel agrees in the uniform(-4, 4) range
    _, pallas_trace = jcgra_run(jprog, inputs, num_iters, batch_tile=batch)
    np.testing.assert_array_equal(trace.numpy(), np.asarray(pallas_trace))
    # and the scalar interpreter on lane 0
    ref = jinterpret_dfg(jprog.mapping.dfg,
                         {v: [float(x) for x in inputs[v][:, 0]] for v in inputs},
                         num_iters)
    for v, stream in ref.items():
        np.testing.assert_allclose(outs[v][:, 0].numpy(), np.asarray(stream, np.float32),
                                   rtol=1e-6, atol=1e-6)


def test_overflowing_operands_follow_the_oracle_not_the_blend():
    """1e20 + 1e20 is 2e20, as cgra_sim_reference says; the Pallas kernel's
    one-hot blend gives NaN there (inf * 0 from the unselected mul)."""
    res = jmap_dfg(_overflow(), JCGRA(2, 2), deterministic=True)
    jprog = jcompile_program(res.mapping)
    prog = compile_program(mapping_from_plain(plain_mapping(res.mapping)))
    inputs = {v: np.full((3, 4), 1e20, np.float32) for v in prog.input_nodes()}
    outs, trace = cgra_run(prog, inputs, 3, device="cpu")
    with np.errstate(invalid="ignore"):    # its bitwise masks of 1e20
        ref_outs, ref_trace = jcgra_sim_reference(jprog, inputs, 3)
    np.testing.assert_array_equal(trace.numpy(), ref_trace)
    (store,) = outs.values()
    assert torch.equal(store, torch.full((3, 4), 2e20))


def test_special_values_match_the_port_oracle():
    """inf, NaN and |x| >= 2^63 through every opcode: the plain version and
    the port's numpy oracle agree (NaN where NaN). The bitwise ops read such
    values as 0, as numpy's unchecked cast does on x86."""
    _, prog, num_iters, _ = _case("opcover_3x3")
    special = np.array([np.inf, -np.inf, np.nan, 1e30, -1e20, 2.0**63, 3.5, -0.0],
                       np.float32)
    masks = [0, 0, 0, 0, 0, 0, 3, 0]
    assert ref_mask16(special).tolist() == masks
    assert torch_mask16(torch.from_numpy(special)).tolist() == masks
    inputs = {v: np.stack([np.roll(special, i + v) for i in range(num_iters)])
              for v in prog.input_nodes()}
    _, trace = cgra_run(prog, inputs, num_iters, device="cpu")
    with np.errstate(all="ignore"):                       # inf - inf etc.
        _, ref = cgra_sim_reference(prog, inputs, num_iters)
    assert np.isnan(ref).any() and np.isinf(ref).any()
    np.testing.assert_array_equal(trace.numpy(), ref)     # NaN == NaN here


def test_cpu_runs_launch_no_kernel():
    before = cgra_sim.launches
    _, prog, num_iters, batch = _case("running_example_2x2_b8")
    cgra_run(prog, _inputs(prog, num_iters, batch), num_iters, device="cpu")
    tables = prog.tables
    x = torch.zeros((tables.num_inputs, 2, 3))
    assert torch.equal(cgra_sim(tables, x), cgra_sim_torch(tables, x))
    assert cgra_sim.launches == before


def test_cgra_run_builds_no_tables(monkeypatch):
    """``compile_program`` builds the executor's tables once; a run only
    reads them."""
    _, prog, num_iters, batch = _case("opcover_3x3")

    def refuse(*args, **kwargs):
        raise AssertionError("cgra_run built tables")

    monkeypatch.setattr(SimTables, "from_numpy", refuse)
    inputs = _inputs(prog, num_iters, batch)
    outs, trace = cgra_run(prog, inputs, num_iters, device="cpu")
    ref_outs, ref_trace = cgra_sim_reference(prog, inputs, num_iters)
    np.testing.assert_array_equal(trace.numpy(), ref_trace)
    assert sorted(outs) == sorted(ref_outs)
    for v in outs:
        np.testing.assert_array_equal(outs[v].numpy(), ref_outs[v])


def test_cpu_run_makes_no_stream_and_counts_no_copy_stream_call(monkeypatch):
    """The CPU path keeps its plain code: no CUDA stream is made or entered,
    no memory is pinned, and no call is counted as one whose copies ran on
    the copy stream."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU run touched a CUDA stream or pinned memory")

    empty = torch.empty

    def empty_unpinned(*args, pin_memory=False, **kwargs):
        if pin_memory:
            refuse()
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "Stream", refuse)
    monkeypatch.setattr(torch.cuda, "stream", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    monkeypatch.setattr(torch, "empty", empty_unpinned)
    monkeypatch.setattr(torch.Tensor, "pin_memory", refuse)
    _, prog, num_iters, batch = _case("running_example_2x2_b8")
    inputs = _inputs(prog, num_iters, batch)
    with obs.tracing() as tracer:
        outs, trace = cgra_run(prog, inputs, num_iters, device="cpu")
    assert tracer.counters.get("exec.copy_stream_calls", 0) == 0
    assert trace.device.type == "cpu" and all(o.device.type == "cpu" for o in outs.values())


@pytest.mark.parametrize("name", ["running_example_2x2_b8", "opcover_3x3", "accum_2x2"])
def test_cgra_sim_with_a_zeroed_trace_equals_cgra_sim_without(name):
    _, prog, num_iters, batch = _case(name)
    tables = prog.tables
    inputs = _inputs(prog, num_iters, batch)
    x = torch.stack([torch.from_numpy(inputs[v]) for v in prog.input_nodes()])
    given = torch.zeros((tables.num_cycles(num_iters), tables.num_pes, batch))
    got = cgra_sim(tables, x, trace=given)
    assert got is given
    assert torch.equal(got, cgra_sim(tables, x))


def test_cgra_sim_rejects_a_trace_of_another_shape_or_dtype():
    _, prog, num_iters, batch = _case("running_example_2x2_b8")
    tables = prog.tables
    x = torch.zeros((tables.num_inputs, num_iters, batch))
    shape = (tables.num_cycles(num_iters), tables.num_pes, batch)
    for bad in (torch.zeros(shape[:2] + (batch + 1,)), torch.zeros(shape, dtype=torch.float64),
                torch.zeros(shape[::-1]).transpose(0, 2)):
        with pytest.raises(ValueError, match="trace"):
            cgra_sim(tables, x, trace=bad)


def test_cgra_run_checks_the_streams_before_it_fills_the_trace(monkeypatch):
    """The streams' shapes are checked on the host before the trace's fill,
    the call's first device work, is enqueued."""
    filled = []
    monkeypatch.setattr(ops, "zero_trace", lambda *a: filled.append(a))
    _, prog, num_iters, batch = _case("running_example_2x2_b8")
    inputs = _inputs(prog, num_iters, batch)
    v0, v1 = prog.input_nodes()[:2]
    with pytest.raises(ValueError, match="iterations"):
        cgra_run(prog, inputs, num_iters + 1, device="cpu")
    with pytest.raises(ValueError, match="all alike"):
        cgra_run(prog, {**inputs, v1: inputs[v1][:, :-1]}, num_iters, device="cpu")
    with pytest.raises(ValueError, match="all alike"):
        cgra_run(prog, {**inputs, v0: inputs[v0][0]}, num_iters, device="cpu")
    with pytest.raises(ValueError, match="B >= 1"):
        cgra_run(prog, {v: a[:, :0] for v, a in inputs.items()}, num_iters, device="cpu")
    assert filled == []


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the machine without one")
    _, prog, num_iters, batch = _case("running_example_2x2_b8")
    inputs = _inputs(prog, num_iters, batch)
    with pytest.raises(RuntimeError, match="CUDA"):
        cgra_run(prog, inputs, num_iters)                  # default is CUDA
    with pytest.raises(RuntimeError, match="CUDA"):
        cgra_run(prog, inputs, num_iters, device="cuda")


def test_wrapper_and_tables_reject_bad_input():
    _, prog, num_iters, batch = _case("running_example_2x2_b8")
    tables = prog.tables
    good = torch.zeros((tables.num_inputs, num_iters, batch))
    with pytest.raises(ValueError, match="float32"):
        cgra_sim(tables, good.double())
    with pytest.raises(ValueError, match="inputs must be"):
        cgra_sim(tables, good[:1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        cgra_sim(tables, good.to("meta"))
    with pytest.raises(ValueError, match="inputs must cover"):
        cgra_run(prog, {}, num_iters, device="cpu")
    bad = {k: getattr(tables, k).numpy().copy() for k in SimTables.TENSOR_FIELDS}
    bad["src_pe"][0, 0] = tables.num_pes                    # off the grid
    with pytest.raises(ValueError, match="malformed"):
        SimTables.from_numpy(ii=tables.ii, num_pes=tables.num_pes,
                             num_inputs=tables.num_inputs, **bad)
