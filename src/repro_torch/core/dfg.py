"""Data-flow graph (DFG) representation for CGRA mapping.

A DFG models one loop body after LLVM-style extraction: nodes are single-cycle
operations (loads, ALU ops, stores), edges are data dependencies. Loop-carried
dependencies close recurrence cycles with an iteration *distance* (usually 1).

The paper (§IV-A) ultimately treats the DFG as an *undirected, labelled* graph
once a time solution is found; we keep the directed + distance-annotated form as
the source of truth and derive the undirected view on demand.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence

# Operation kinds understood by the functional simulator (core/simulate.py) and
# the cgra_sim CUDA kernel. Arity is used by DFG validation.
OP_ARITY = {
    "input": 0,   # live-in (loop invariant or streamed input)
    "const": 0,
    "load": 1,    # load base+offset (address operand)
    "store": 1,   # value operand (address folded into the op immediate)
    "add": 2,
    "sub": 2,
    "mul": 2,
    "div": 2,
    "and": 2,
    "or": 2,
    "xor": 2,
    "shl": 2,
    "shr": 2,
    "min": 2,
    "max": 2,
    "neg": 1,
    "not": 1,
    "abs": 1,
    "mov": 1,     # copy / route-through
    "phi": 2,     # loop-carried merge
    "cmp": 2,
}


@dataclass(frozen=True)
class Edge:
    """Directed dependency src -> dst.

    distance == 0: intra-iteration data dependency.
    distance >= 1: loop-carried dependency (value produced `distance`
    iterations before it is consumed).

    ``port`` pins the edge to an explicit operand slot of ``dst`` (0 = first
    operand). -1 (the default) means "unpinned": the canonical operand order
    is then ``(distance, src)``, which is what every frontend produces. The
    route-through rewrite (:func:`splice_routes`) pins ports on the consumers
    it touches so replacing a producer with a ``mov`` chain cannot reorder
    the operands of a non-commutative op.
    """

    src: int
    dst: int
    distance: int = 0
    port: int = -1

    def __post_init__(self) -> None:
        if self.distance < 0:
            raise ValueError(f"negative dependency distance on edge {self}")
        if self.port < -1:
            raise ValueError(f"invalid operand port on edge {self}")

    def _operand_key(self) -> tuple:
        # pinned ports order first among themselves; unpinned edges keep the
        # historical (distance, src) order — a node's in-edges are either all
        # pinned (route-through rewrite) or all unpinned (frontends)
        return (0, self.port) if self.port >= 0 else (1, self.distance, self.src)


@dataclass
class DFG:
    """A directed data-flow graph with loop-carried distances.

    The compiler's input: one loop body whose nodes are single-cycle ops and
    whose edges carry an iteration *distance* (0 = intra-iteration,
    ≥1 = loop-carried). A mapping assigns each node an absolute time
    (*label* ``t mod II`` + *fold* ``t div II``, DESIGN.md §1) and a PE.

    Example — a 2-node accumulator with a distance-1 recurrence::

        from repro_torch.core import DFG, Edge

        dfg = DFG(num_nodes=2, ops=["input", "add"],
                  edges=[Edge(0, 1), Edge(1, 1, distance=1)],
                  name="acc")
        dfg.validate()              # intra-iteration part must be a DAG
        assert dfg.rec_ii() == 1    # 1-edge cycle / distance 1
        text = dfg.to_json()        # round-trips via DFG.from_json
        assert DFG.from_json(text).stable_hash() == dfg.stable_hash()

    ``stable_hash()`` is the content address used by both mapping-cache
    layers; ``name`` and ``imms`` are deliberately excluded from it.
    """

    num_nodes: int
    edges: list[Edge]
    ops: list[str] = field(default_factory=list)
    name: str = "dfg"
    # Optional per-node immediate (e.g. constant value / address offset).
    imms: list[float] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.ops:
            self.ops = ["add"] * self.num_nodes
        if not self.imms:
            self.imms = [0.0] * self.num_nodes
        if len(self.ops) != self.num_nodes or len(self.imms) != self.num_nodes:
            raise ValueError(f"{self.name}: ops/imms length mismatch with num_nodes")
        for e in self.edges:
            if not (0 <= e.src < self.num_nodes and 0 <= e.dst < self.num_nodes):
                raise ValueError(f"{self.name}: edge {e} out of range")

    # ------------------------------------------------------------------ views
    @property
    def nodes(self) -> range:
        return range(self.num_nodes)

    def predecessors(self, v: int, *, carried: bool | None = None) -> list[Edge]:
        return [
            e
            for e in self.edges
            if e.dst == v
            and (carried is None or (e.distance > 0) == carried)
        ]

    def successors(self, v: int, *, carried: bool | None = None) -> list[Edge]:
        return [
            e
            for e in self.edges
            if e.src == v
            and (carried is None or (e.distance > 0) == carried)
        ]

    def operands(self, v: int) -> list[Edge]:
        """The canonical operand order of node ``v``.

        Single source of truth shared by the scalar oracle
        (``simulate._operands``) and the program builder
        (``kernels/ops.py``): explicit ``Edge.port`` pins win, unpinned edges
        fall back to the historical ``(distance, src)`` order.
        """
        return sorted(self.predecessors(v), key=Edge._operand_key)

    def undirected_adjacency(self) -> list[set[int]]:
        """Paper §IV-B: after scheduling, edge direction is dropped."""
        adj: list[set[int]] = [set() for _ in self.nodes]
        for e in self.edges:
            if e.src != e.dst:
                adj[e.src].add(e.dst)
                adj[e.dst].add(e.src)
        return adj

    def intra_edges(self) -> list[Edge]:
        return [e for e in self.edges if e.distance == 0]

    def carried_edges(self) -> list[Edge]:
        return [e for e in self.edges if e.distance > 0]

    # ------------------------------------------------------------- validation
    def validate(self) -> None:
        """Check the intra-iteration subgraph is a DAG and arities are sane."""
        indeg = [0] * self.num_nodes
        adj: list[list[int]] = [[] for _ in self.nodes]
        for e in self.intra_edges():
            adj[e.src].append(e.dst)
            indeg[e.dst] += 1
        frontier = [v for v in self.nodes if indeg[v] == 0]
        seen = 0
        while frontier:
            v = frontier.pop()
            seen += 1
            for w in adj[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    frontier.append(w)
        if seen != self.num_nodes:
            raise ValueError(f"{self.name}: intra-iteration dependency cycle (needs distance>=1)")
        for v in self.nodes:
            op = self.ops[v]
            if op not in OP_ARITY:
                raise ValueError(f"{self.name}: unknown op {op!r} at node {v}")
            np_ = len(self.predecessors(v))
            if op in ("input", "const") and np_ != 0:
                raise ValueError(f"{self.name}: node {v} ({op}) must have no inputs")
            if OP_ARITY[op] > 0 and np_ > OP_ARITY[op]:
                raise ValueError(
                    f"{self.name}: node {v} ({op}) has {np_} inputs > arity {OP_ARITY[op]}"
                )

    # ---------------------------------------------------------- recurrence II
    def rec_ii(self) -> int:
        """RecII = max over dependence cycles of ceil(length/distance).

        Single-cycle ops => cycle length = #edges in the cycle. Computed with a
        Bellman-Ford style iteration: for a candidate II, edge (u,v,dist) imposes
        t_v >= t_u + 1 - II*dist; a positive cycle in that constraint graph means
        II is infeasible. RecII is the smallest feasible II. DFG sizes here are
        tens of nodes, so the O(V*E*II) search is trivial.
        """
        if not self.edges:
            return 1
        max_ii = max(2, self.num_nodes + 1)
        for ii in range(1, max_ii + 1):
            if self._feasible_ii(ii):
                return ii
        return max_ii

    def _feasible_ii(self, ii: int) -> bool:
        dist = [0] * self.num_nodes
        for _ in range(self.num_nodes):
            changed = False
            for e in self.edges:
                w = 1 - ii * e.distance
                if dist[e.src] + w > dist[e.dst]:
                    dist[e.dst] = dist[e.src] + w
                    changed = True
            if not changed:
                return True
        # one more relaxation round: still-changing => positive cycle
        for e in self.edges:
            if dist[e.src] + (1 - ii * e.distance) > dist[e.dst]:
                return False
        return True

    def stable_hash(self) -> str:
        """Content hash over the mapping-relevant structure (nodes + edges).

        Used as the mapping-cache key (core/mapper.py): two DFGs with the same
        hash admit exactly the same space-time mappings. ``imms``/``name`` are
        excluded — they do not affect mapping feasibility.
        """
        import hashlib

        payload = json.dumps(
            {
                "n": self.num_nodes,
                "ops": self.ops,
                "edges": sorted((e.src, e.dst, e.distance) for e in self.edges),
            },
            sort_keys=True,
            separators=(",", ":"),
        )
        return hashlib.sha1(payload.encode()).hexdigest()

    # ------------------------------------------------------------------- I/O
    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "num_nodes": self.num_nodes,
                "ops": self.ops,
                "imms": self.imms,
                "edges": [
                    [e.src, e.dst, e.distance] if e.port < 0
                    else [e.src, e.dst, e.distance, e.port]
                    for e in self.edges
                ],
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "DFG":
        d = json.loads(text)
        return cls(
            num_nodes=d["num_nodes"],
            edges=[Edge(*e) for e in d["edges"]],
            ops=d.get("ops", []),
            imms=d.get("imms", []),
            name=d.get("name", "dfg"),
        )

    @classmethod
    def from_edge_list(
        cls,
        num_nodes: int,
        edges: Iterable[tuple[int, int] | tuple[int, int, int]],
        *,
        ops: Sequence[str] | None = None,
        name: str = "dfg",
    ) -> "DFG":
        es = [Edge(*((*e, 0)[:3])) for e in edges]
        return cls(num_nodes=num_nodes, edges=es, ops=list(ops or []), name=name)


# ------------------------------------------------------- route-through rewrite

@dataclass(frozen=True)
class Route:
    """Provenance of one route-through rewrite (DESIGN.md §12.2).

    The original edge ``src -> dst`` (with its loop-carried ``distance``) was
    replaced by the chain ``src -> movs[0] -> ... -> movs[-1] -> dst``; every
    intermediate is a ``mov`` node appended to the rewritten DFG, and only the
    final chain edge keeps the original distance. Mapping results carry these
    so consumers can report placements of *original* nodes (ids below
    ``Route.movs`` are unchanged by construction) and both cache layers can
    reconstruct the rewritten DFG from ``(src, dst, distance, len(movs))``.
    """

    src: int
    dst: int
    distance: int
    movs: tuple[int, ...]

    def spec(self) -> tuple[int, int, int, int]:
        """The compact JSON-able form both mapping caches store."""
        return (self.src, self.dst, self.distance, len(self.movs))


def splice_routes(
    dfg: DFG, specs: Sequence[tuple[int, int, int, int]]
) -> tuple[DFG, list[Route]]:
    """Rewrite ``dfg`` by splicing ``mov`` chains onto the given edges.

    ``specs`` is a sequence of ``(src, dst, distance, n_movs)`` — one per
    rewritten edge, each matching a distinct existing edge (duplicated edges
    are consumed first-to-last). Mov node ids are allocated contiguously from
    ``dfg.num_nodes`` in spec order, so original node ids (and therefore
    input/store identities) are preserved. Operand order of every touched
    consumer is pinned via explicit edge ports *before* the rewrite, so the
    rewritten DFG computes exactly what the original does (the movs are
    identity ops) — including non-commutative consumers.

    Returns ``(routed_dfg, routes)``; raises ValueError when a spec matches
    no remaining edge or asks for zero movs.
    """
    edges = list(dfg.edges)
    consumed: set[int] = set()
    ops = list(dfg.ops)
    imms = list(dfg.imms)
    routes: list[Route] = []
    next_id = dfg.num_nodes

    # pin operand order on every dst a rewrite touches (ports reflect the
    # original canonical order, so untouched consumers keep their semantics)
    touched = {dst for (_s, dst, _d, _n) in specs}
    port_of: dict[int, int] = {}        # edge index -> pinned port
    for v in touched:
        idxs = [i for i, e in enumerate(edges) if e.dst == v]
        idxs.sort(key=lambda i: edges[i]._operand_key())
        for slot, i in enumerate(idxs):
            port_of[i] = slot
    for i, slot in port_of.items():
        e = edges[i]
        edges[i] = Edge(e.src, e.dst, e.distance, port=slot)

    new_edges: list[Edge] = []
    for src, dst, distance, n_movs in specs:
        if n_movs < 1:
            raise ValueError(f"route on edge ({src},{dst},{distance}) has no movs")
        idx = next(
            (i for i, e in enumerate(edges)
             if i not in consumed
             and (e.src, e.dst, e.distance) == (src, dst, distance)),
            None,
        )
        if idx is None:
            raise ValueError(
                f"no unrouted edge ({src},{dst},{distance}) in {dfg.name!r}"
            )
        consumed.add(idx)
        movs = tuple(range(next_id, next_id + n_movs))
        next_id += n_movs
        ops.extend("mov" for _ in movs)
        imms.extend(0.0 for _ in movs)
        prev = src
        for m in movs:
            new_edges.append(Edge(prev, m, 0))
            prev = m
        # the final hop keeps the original distance and the pinned port
        edges[idx] = Edge(prev, dst, distance, port=edges[idx].port)
        routes.append(Route(src=src, dst=dst, distance=distance, movs=movs))

    routed = DFG(
        num_nodes=next_id,
        edges=edges + new_edges,
        ops=ops,
        imms=imms,
        name=dfg.name,
    )
    return routed, routes


def running_example() -> DFG:
    """The paper's 14-node running example (Fig. 2a), reconstructed.

    Exact edge identities in the figure are partially illegible in the text;
    we reconstruct a 14-node DFG whose ASAP/ALAP/MobS match Tab. I exactly
    (verified in tests/test_schedule.py) and whose RecII = 4, giving
    mII = max(ceil(14/4), 4) = 4 on a 2x2 CGRA as in the paper.
    """
    # ASAP rows (Tab. I): t0: 0 1 2 3 4 | t1: 5 11 | t2: 6 12 | t3: 7 8 13 | t4: 9 | t5: 10
    # ALAP rows:          t0: 4 | t1: 3 5 | t2: 0 2 6 | t3: 1 8 11 | t4: 7 9 12 | t5: 10 13
    edges = [
        # intra-iteration data dependencies (black edges)
        Edge(4, 5),    # 4 alap0 -> 5 (asap1, alap1)
        Edge(5, 6), Edge(3, 6),         # 6: asap2, alap2; pins alap(3)=1
        Edge(6, 7), Edge(1, 7),         # 7: asap3, alap4; pins alap(1)=3
        Edge(6, 8), Edge(2, 8),         # 8: asap3, alap3; pins alap(2)=2
        Edge(8, 9),                     # 9: asap4, alap4
        Edge(9, 10), Edge(7, 10),       # 10: asap5, alap5 (sink)
        Edge(0, 11), Edge(11, 12), Edge(12, 13),  # 11..13 side chain; pins alap(0)=2
        # loop-carried dependencies (red edges); close RecII=4 cycle 5-6-8-9
        Edge(9, 5, 1),
        Edge(13, 11, 1),
    ]
    ops = [
        "input", "input", "input", "input", "input",
        "phi", "add", "mul", "sub", "add",
        "add", "phi", "mul", "add",
    ]
    return DFG(num_nodes=14, edges=edges, ops=ops, name="running_example")
