"""The plain reference: a NumPy interpreter of a frozen DFG.

It reads the DFG from its frozen JSON (``data/dfgs/<kernel>.json``) and runs
the loop iteration by iteration over every lane at once, in float32, with
the ALU semantics the paper's machine model states (DESIGN.md §2,
``core/simulate.py::alu`` of the port, copied here so that the port cannot
move it): single-cycle ops, a loop-carried operand reads 0 before its first
producing iteration, bitwise ops work on 16-bit casts of |x|, division by 0
gives 0, and min/max propagate NaN.

It imports no part of the port and takes nothing the port made: the stores
it computes depend only on the DFG and the input streams, never on a
mapping.

``precision="bfloat16"`` rounds every value to bfloat16 after each op: the
control of the check, which must come out not correct.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

F32 = np.float32


@dataclass(frozen=True)
class PlainDFG:
    """A DFG as its frozen JSON states it."""

    name: str
    ops: tuple[str, ...]
    imms: tuple[float, ...]
    edges: tuple[tuple[int, int, int, int], ...]   # (src, dst, distance, port)

    @property
    def num_nodes(self) -> int:
        return len(self.ops)

    @classmethod
    def from_json(cls, text: str) -> "PlainDFG":
        d = json.loads(text)
        n = d["num_nodes"]
        ops = tuple(d["ops"])
        imms = tuple(float(x) for x in d.get("imms") or [0.0] * n)
        edges = tuple((e[0], e[1], e[2], e[3] if len(e) > 3 else -1)
                      for e in d["edges"])
        if len(ops) != n or len(imms) != n:
            raise ValueError(f"{d.get('name')}: ops/imms do not match num_nodes")
        return cls(name=d["name"], ops=ops, imms=imms, edges=edges)

    @classmethod
    def load(cls, path: Path) -> "PlainDFG":
        return cls.from_json(Path(path).read_text())

    def inputs(self) -> list[int]:
        """Input nodes in stream-slot order (ascending ids)."""
        return [v for v, op in enumerate(self.ops) if op == "input"]

    def stores(self) -> list[int]:
        return [v for v, op in enumerate(self.ops) if op == "store"]

    def operands(self, v: int) -> list[tuple[int, int, int, int]]:
        """Operand order: pinned ports first by port, then unpinned edges by
        (distance, src)."""
        ins = [e for e in self.edges if e[1] == v]
        return sorted(ins, key=lambda e: (0, e[3]) if e[3] >= 0 else (1, e[2], e[0]))

    def topo_order(self) -> list[int]:
        """An order of the intra-iteration (distance 0) DAG."""
        indeg = [0] * self.num_nodes
        succ: list[list[int]] = [[] for _ in range(self.num_nodes)]
        for s, d, dist, _ in self.edges:
            if dist == 0:
                succ[s].append(d)
                indeg[d] += 1
        ready = [v for v in range(self.num_nodes) if indeg[v] == 0]
        order = []
        while ready:
            v = ready.pop()
            order.append(v)
            for w in succ[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    ready.append(w)
        if len(order) != self.num_nodes:
            raise ValueError(f"{self.name}: cyclic intra-iteration dependencies")
        return order


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """Round float32 values to the nearest bfloat16 (ties to even), kept in
    float32; NaN and inf stay as they are."""
    x = np.asarray(x, F32)
    bits = x.view(np.uint32).astype(np.uint64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    out = rounded.view(F32)
    return np.where(np.isfinite(x), out, x)


def _mask16(x: np.ndarray) -> np.ndarray:
    """(int64)|x| & 0xFFFF, and 0 where |x| >= 2^63, inf or NaN."""
    ax = np.abs(x)
    return np.where(ax < F32(2.0**63), ax, F32(0)).astype(np.int64) & 0xFFFF


def alu(op: str, a: np.ndarray, b: np.ndarray, imm: float) -> np.ndarray:
    """One op over float32 lanes."""
    if op == "const":
        return np.full_like(a, F32(imm))
    if op in ("load", "store", "mov"):
        return a
    if op in ("add", "phi"):
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "div":
        nz = b != 0
        return np.where(nz, a / np.where(nz, b, F32(1)), F32(0)).astype(F32)
    if op == "min":
        return np.minimum(a, b)
    if op == "max":
        return np.maximum(a, b)
    if op == "neg":
        return -a
    if op == "abs":
        return np.abs(a)
    if op == "cmp":
        return (a > b).astype(F32)
    ia, ib = _mask16(a), _mask16(b)
    sh = ib % 8
    if op == "and":
        r = ia & ib
    elif op == "or":
        r = ia | ib
    elif op == "xor":
        r = ia ^ ib
    elif op == "shl":
        r = (ia << sh) & 0xFFFF
    elif op == "shr":
        r = ia >> sh
    elif op == "not":
        r = ~ia & 0xFFFF
    else:
        raise ValueError(f"op {op!r} has no ALU semantics")
    return r.astype(F32)


def interpret(dfg: PlainDFG, inputs: dict[int, np.ndarray], num_iters: int,
              *, precision: str = "float32") -> dict[int, np.ndarray]:
    """Run the loop over ``inputs`` (input node -> [num_iters, B] float32);
    returns each store node's stream [num_iters, B]."""
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"unknown precision {precision!r}")
    rnd = to_bfloat16 if precision == "bfloat16" else (lambda x: x)
    order = dfg.topo_order()
    operands = [dfg.operands(v) for v in range(dfg.num_nodes)]
    depth = max((e[2] for e in dfg.edges), default=0)
    batch = next(iter(inputs.values())).shape[1] if inputs else 1
    zero = np.zeros(batch, F32)
    history: list[list[np.ndarray]] = []     # the last `depth` iterations
    outs = {v: np.empty((num_iters, batch), F32) for v in dfg.stores()}
    for it in range(num_iters):
        cur: list[np.ndarray | None] = [None] * dfg.num_nodes
        for v in order:
            op = dfg.ops[v]
            if op == "input":
                cur[v] = rnd(np.asarray(inputs[v][it], F32))
                continue
            args = []
            for src, _, dist, _ in operands[v]:
                if dist == 0:
                    args.append(cur[src])
                else:
                    back = len(history) - dist
                    args.append(history[back][src] if back >= 0 else zero)
            a = args[0] if args else zero
            b = args[1] if len(args) > 1 else zero
            cur[v] = rnd(alu(op, a, b, dfg.imms[v]))
            if op == "store":
                outs[v][it] = cur[v]
        if depth:
            history.append(cur)
            del history[:-depth]
    return outs


def mismatches(got: dict[int, np.ndarray], want: dict[int, np.ndarray]) -> int:
    """Store values that differ (NaN equals NaN); a store missing on either
    side, or of another shape, counts every value of it."""
    n = 0
    for v in set(got) | set(want):
        g, w = got.get(v), want.get(v)
        if g is None or w is None or np.shape(g) != np.shape(w):
            n += max(int(np.size(x)) for x in (g, w) if x is not None)
            continue
        g, w = np.asarray(g), np.asarray(w)
        same = (g == w) | (np.isnan(g) & np.isnan(w))
        n += int(same.size - np.count_nonzero(same))
    return n
