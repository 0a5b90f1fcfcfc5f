"""Tracing frontend: extract a DFG from a Python loop body.

The paper's pipeline starts from LLVM IR (unavailable offline, DESIGN.md §2);
this frontend provides the equivalent entry point for Python-described loop
kernels: write the loop body once with ordinary operators, trace it into a
DFG, map it, then validate/execute the mapping against the *same function*.

    def body(ins, carried):
        acc = carried["acc"] + ins[0] * ins[1]   # multiply-accumulate
        return [acc], {"acc": acc}               # stores, next-iteration state

    dfg = trace_loop(body, num_inputs=2, carried=["acc"])
    mapping = map_dfg(dfg, CGRA(2, 2)).mapping

Carried state becomes phi nodes closed by distance-1 loop edges (phi(init, x)
= init + x with init stream = 0-padded first iteration, matching the
simulator's accumulate semantics). Supported ops mirror the CGRA ALU.
"""

from __future__ import annotations

from typing import Callable, Sequence

from .dfg import DFG, Edge


class _Tracer:
    def __init__(self) -> None:
        self.ops: list[str] = []
        self.imms: list[float] = []
        self.edges: list[Edge] = []

    def node(self, op: str, *args: "Var", imm: float = 0.0) -> "Var":
        nid = len(self.ops)
        self.ops.append(op)
        self.imms.append(imm)
        for a in args:
            if not isinstance(a, Var) or a.tracer is not self:
                raise TypeError("operands must be Vars from the same trace")
            self.edges.append(Edge(a.nid, nid))
        return Var(self, nid)


class Var:
    """A traced value; operators append DFG nodes."""

    def __init__(self, tracer: _Tracer, nid: int) -> None:
        self.tracer = tracer
        self.nid = nid

    def _lift(self, other) -> "Var":
        if isinstance(other, Var):
            return other
        return self.tracer.node("const", imm=float(other))

    def _bin(self, op: str, other) -> "Var":
        return self.tracer.node(op, self, self._lift(other))

    def __add__(self, o):  return self._bin("add", o)
    def __radd__(self, o): return self._lift(o)._bin("add", self)
    def __sub__(self, o):  return self._bin("sub", o)
    def __rsub__(self, o): return self._lift(o)._bin("sub", self)
    def __mul__(self, o):  return self._bin("mul", o)
    def __rmul__(self, o): return self._lift(o)._bin("mul", self)
    def __truediv__(self, o):  return self._bin("div", o)
    def __and__(self, o):  return self._bin("and", o)
    def __or__(self, o):   return self._bin("or", o)
    def __xor__(self, o):  return self._bin("xor", o)
    def __lshift__(self, o): return self._bin("shl", o)
    def __rshift__(self, o): return self._bin("shr", o)
    def __neg__(self):     return self.tracer.node("neg", self)
    def __invert__(self):  return self.tracer.node("not", self)
    def __abs__(self):     return self.tracer.node("abs", self)
    def __gt__(self, o):   return self._bin("cmp", o)

    def min(self, o):      return self._bin("min", o)
    def max(self, o):      return self._bin("max", o)


def trace_loop(
    body: Callable,
    *,
    num_inputs: int,
    carried: Sequence[str] = (),
    name: str = "traced",
) -> DFG:
    """Trace `body(inputs, carried_dict) -> (stores, new_carried_dict)`."""
    tr = _Tracer()
    ins = [tr.node("input") for _ in range(num_inputs)]
    phis = {k: tr.node("phi") for k in carried}
    # phi's first (intra) operand: a zero const initialiser keeps arity valid
    # when the body uses the carried value without adding an intra input.
    stores, new_carried = body(ins, dict(phis))
    if set(new_carried) != set(carried):
        raise ValueError(f"carried keys changed: {set(new_carried)} != {set(carried)}")
    for k, phi in phis.items():
        nxt = new_carried[k]
        if not isinstance(nxt, Var):
            raise TypeError(f"carried value {k!r} must be a Var")
        tr.edges.append(Edge(nxt.nid, phi.nid, 1))   # loop-carried edge
    for s in stores:
        tr.node("store", s)
    dfg = DFG(
        num_nodes=len(tr.ops), edges=tr.edges, ops=tr.ops, imms=tr.imms,
        name=name,
    )
    dfg.validate()
    return dfg
