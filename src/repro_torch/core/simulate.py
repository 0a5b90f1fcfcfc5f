"""Functional validation of mappings by execution (reference + mapped).

Two executors over the same ALU semantics:

  * ``interpret_dfg`` — direct, iteration-by-iteration reference execution of
    the loop's DFG (the "what the loop computes" oracle).
  * ``execute_mapping`` — cycle-accurate modulo-scheduled execution of a
    space-time mapping on the register-file CGRA model: every operand read
    asserts (a) the value was already produced, (b) the producer PE is
    closed-adjacent to the consumer PE. Any scheduling/placement bug surfaces
    as a hard error; outputs must match the reference bit-for-bit.

Also provides the opcode table shared with kernels/cgra_sim.py and a
register-pressure probe (paper §V-3 assumes enough registers; we measure).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .cgra import op_class
from .dfg import DFG, OP_ARITY
from .mapper import Mapping

# Stable opcode numbering shared with the CUDA kernel (kernels/csrc/cgra_sim.cu).
OPCODES: dict[str, int] = {
    name: i
    for i, name in enumerate(
        [
            "input", "const", "load", "store", "add", "sub", "mul", "div",
            "and", "or", "xor", "shl", "shr", "min", "max", "neg", "not",
            "abs", "mov", "phi", "cmp",
        ]
    )
}


def alu(op: str, a: float, b: float, imm: float) -> float:
    """Scalar ALU semantics, float domain.

    Bitwise ops work on 16-bit casts of |x| so results are exactly
    representable in float32 — keeping this oracle bit-identical to the
    CUDA kernel (kernels/csrc/cgra_sim.cu), which computes in f32.
    """
    ia, ib = int(abs(a)) & 0xFFFF, int(abs(b)) & 0xFFFF
    if op in ("input", "const"):
        return imm
    if op in ("load", "mov", "store"):
        return a
    if op == "phi":
        # loop-carried merge: accumulate (carried operand is 0 on iteration 0),
        # which makes recurrences semantically live for equivalence testing
        return a + b
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "div":
        return a / b if b != 0 else 0.0
    if op == "and":
        return float(ia & ib)
    if op == "or":
        return float(ia | ib)
    if op == "xor":
        return float(ia ^ ib)
    if op == "shl":
        return float((ia << (ib % 8)) & 0xFFFF)
    if op == "shr":
        return float(ia >> (ib % 8))
    if op == "min":
        return min(a, b)
    if op == "max":
        return max(a, b)
    if op == "neg":
        return -a
    if op == "not":
        return float(~ia & 0xFFFF)
    if op == "abs":
        return abs(a)
    if op == "cmp":
        return 1.0 if a > b else 0.0
    raise ValueError(f"unknown op {op}")


def _operands(dfg: DFG, v: int) -> list:
    """Deterministic operand order: ``DFG.operands`` (port pins, then
    intra edges first, then carried, by src). Shared with kernels/ops.py."""
    return dfg.operands(v)


def interpret_dfg(
    dfg: DFG, inputs: dict[int, list[float]], num_iters: int
) -> dict[int, list[float]]:
    """Reference execution; returns per-store-node output streams."""
    order = _topo(dfg)
    vals: list[dict[int, float]] = []  # per iteration: node -> value
    outs: dict[int, list[float]] = {
        v: [] for v in dfg.nodes if dfg.ops[v] == "store"
    }
    for it in range(num_iters):
        cur: dict[int, float] = {}
        for v in order:
            op = dfg.ops[v]
            if op == "input":
                cur[v] = inputs[v][it]
                continue
            if op == "const":
                cur[v] = dfg.imms[v]
                continue
            args: list[float] = []
            for e in _operands(dfg, v):
                if e.distance == 0:
                    args.append(cur[e.src])
                else:
                    src_it = it - e.distance
                    args.append(vals[src_it][e.src] if src_it >= 0 else 0.0)
            a = args[0] if args else 0.0
            b = args[1] if len(args) > 1 else 0.0
            cur[v] = alu(op, a, b, dfg.imms[v])
            if op == "store":
                outs[v].append(cur[v])
        vals.append(cur)
    return outs


@dataclass
class ExecutionReport:
    outputs: dict[int, list[float]]
    max_register_pressure: dict[int, int]  # pe -> max simultaneous live values
    cycles: int


def execute_mapping(
    mapping: Mapping, inputs: dict[int, list[float]], num_iters: int
) -> ExecutionReport:
    """Cycle-accurate modulo-scheduled execution on the CGRA model.

    Beyond routing/timing, heterogeneous grids (core/arch, DESIGN.md §10)
    are enforced as hard errors: an op on a PE lacking its capability class,
    or a cycle firing more memory ops than the grid has ports, raises — the
    oracle double-checks the mapper's capability bookkeeping independently.
    """
    dfg, cgra, ii = mapping.dfg, mapping.cgra, mapping.ii
    t_abs, placement = mapping.t_abs, mapping.placement
    for v in dfg.nodes:
        cls = op_class(dfg.ops[v])
        if not cgra.capable(placement[v], cls):
            raise AssertionError(
                f"capability violation: node {v} ({dfg.ops[v]}, class {cls!r}) "
                f"mapped to PE {placement[v]} which lacks it"
            )
    total_cycles = max(t_abs) + 1 + (num_iters - 1) * ii
    # register files: pe -> {(producer_node, iteration): value}
    regs: list[dict[tuple[int, int], float]] = [dict() for _ in range(cgra.num_pes)]
    outs: dict[int, list[float]] = {
        v: [0.0] * num_iters for v in dfg.nodes if dfg.ops[v] == "store"
    }
    pressure = [0] * cgra.num_pes
    # last consumer cycle of each (node, iteration) value, for liveness
    last_use: dict[tuple[int, int], int] = {}
    for v in dfg.nodes:
        for e in _operands(dfg, v):
            for it in range(num_iters):
                src_it = it - e.distance
                if src_it < 0:
                    continue
                c = t_abs[v] + it * ii
                key = (e.src, src_it)
                last_use[key] = max(last_use.get(key, -1), c)

    for c in range(total_cycles):
        # ops whose (cycle - t_abs) is a non-negative multiple of II fire now
        firing = []
        for v in dfg.nodes:
            d = c - t_abs[v]
            if d >= 0 and d % ii == 0 and d // ii < num_iters:
                firing.append((v, d // ii))
        if cgra.mem_ports is not None:
            mem_firing = sum(
                1 for v, _ in firing if op_class(dfg.ops[v]) == "mem"
            )
            if mem_firing > cgra.mem_ports:
                raise AssertionError(
                    f"memory-port violation: {mem_firing} memory ops fire at "
                    f"cycle {c} > {cgra.mem_ports} ports"
                )
        for v, it in firing:
            op = dfg.ops[v]
            pe = placement[v]
            if op == "input":
                val = inputs[v][it]
            elif op == "const":
                val = dfg.imms[v]
            else:
                args: list[float] = []
                for e in _operands(dfg, v):
                    src_it = it - e.distance
                    if src_it < 0:
                        args.append(0.0)
                        continue
                    src_pe = placement[e.src]
                    if not cgra.adjacency[pe][src_pe]:
                        raise AssertionError(
                            f"routing violation: node {v}@PE{pe} reads node "
                            f"{e.src}@PE{src_pe} (not adjacent)"
                        )
                    key = (e.src, src_it)
                    if key not in regs[src_pe]:
                        raise AssertionError(
                            f"timing violation: node {v} it={it} cycle={c} reads "
                            f"{key} not yet produced"
                        )
                    args.append(regs[src_pe][key])
                a = args[0] if args else 0.0
                b = args[1] if len(args) > 1 else 0.0
                val = alu(op, a, b, dfg.imms[v])
            regs[pe][(v, it)] = val
            if op == "store":
                outs[v][it] = val
        # retire dead values; record pressure
        for pe in range(cgra.num_pes):
            dead = [k for k in regs[pe] if last_use.get(k, -1) <= c]
            pressure[pe] = max(pressure[pe], len(regs[pe]))
            for k in dead:
                del regs[pe][k]
    return ExecutionReport(
        outputs=outs,
        max_register_pressure={pe: p for pe, p in enumerate(pressure) if p},
        cycles=total_cycles,
    )


def check_equivalence(
    mapping: Mapping, *, num_iters: int = 8, seed: int = 0
) -> ExecutionReport:
    """Run both executors on random inputs and assert identical outputs."""
    import random

    rng = random.Random(seed)
    inputs = {
        v: [round(rng.uniform(-4, 4), 3) for _ in range(num_iters)]
        for v in mapping.dfg.nodes
        if mapping.dfg.ops[v] == "input"
    }
    ref = interpret_dfg(mapping.dfg, inputs, num_iters)
    rep = execute_mapping(mapping, inputs, num_iters)
    for v, stream in ref.items():
        got = rep.outputs[v][: len(stream)]
        if got != stream:
            raise AssertionError(
                f"mapped execution diverges at store node {v}: {got} != {stream}"
            )
    return rep


def utilization_report(mapping: Mapping) -> dict:
    """Fabric-occupancy summary of a mapping (JSON-friendly).

    Per the modulo-scheduling model, each node occupies exactly one
    ``(pe, t_abs % ii)`` slot, so a fabric of ``num_pes`` PEs at initiation
    interval ``ii`` offers ``num_pes * ii`` slots. The report gives:

    * ``pes_used`` / ``occupancy`` — how much of the fabric the placement
      actually touches (the interesting number on 50×50+ grids, where a
      kernel lights up a tiny corner);
    * ``per_pe`` — used-slot count for each *used* PE only (an empty dict
      entry per idle PE would dwarf the row on large fabrics);
    * ``route_movs`` / ``route_wire_hops`` — route-through cost from
      ``Mapping.routes``: a spliced route with *n* movs spans *n + 1*
      wire hops between its original producer and consumer.
    """
    ii, num_pes = mapping.ii, mapping.cgra.num_pes
    per_pe: dict[int, int] = {}
    for v in mapping.dfg.nodes:
        pe = mapping.placement[v]
        per_pe[pe] = per_pe.get(pe, 0) + 1
    slots_used = sum(per_pe.values())
    slots_total = num_pes * ii
    return {
        "num_pes": num_pes,
        "ii": ii,
        "pes_used": len(per_pe),
        "slots_used": slots_used,
        "slots_total": slots_total,
        "occupancy": round(slots_used / slots_total, 6),
        "per_pe": {pe: per_pe[pe] for pe in sorted(per_pe)},
        "route_movs": mapping.num_route_movs,
        "route_wire_hops": sum(len(r.movs) + 1 for r in mapping.routes),
    }


def register_pressure_by_pe(
    mapping: Mapping, *, num_iters: int | None = None
) -> dict[int, int]:
    """Max simultaneous live values per PE (only PEs with pressure > 0).

    The per-PE resolution matters on heterogeneous register files
    (``CGRA.registers_at`` / ``ArchSpec.registers_by_class``):
    ``Mapping.validate`` compares each PE's pressure against that PE's own
    bound instead of one grid-wide scalar.

    ``num_iters=None`` (the default) probes ``num_stages + 2`` iterations (at
    least 8): a value can stay live for up to ``num_stages`` interleaved
    iterations, so a fixed shallow probe under-reports the steady state of
    deep pipelines — exactly the regime where register files overflow.
    """
    if num_iters is None:
        num_iters = max(8, mapping.num_stages + 2)
    inputs = {
        v: [1.0] * num_iters
        for v in mapping.dfg.nodes
        if mapping.dfg.ops[v] == "input"
    }
    rep = execute_mapping(mapping, inputs, num_iters)
    return rep.max_register_pressure


def check_register_pressure(
    mapping: Mapping, *, num_iters: int | None = None
) -> int:
    """Max simultaneous live values on any PE (paper assumes this fits)."""
    by_pe = register_pressure_by_pe(mapping, num_iters=num_iters)
    return max(by_pe.values(), default=0)


def _topo(dfg: DFG) -> list[int]:
    indeg = [0] * dfg.num_nodes
    adj: list[list[int]] = [[] for _ in dfg.nodes]
    for e in dfg.intra_edges():
        adj[e.src].append(e.dst)
        indeg[e.dst] += 1
    stack = [v for v in dfg.nodes if indeg[v] == 0]
    order = []
    while stack:
        v = stack.pop()
        order.append(v)
        for w in adj[v]:
            indeg[w] -= 1
            if indeg[w] == 0:
                stack.append(w)
    return order
