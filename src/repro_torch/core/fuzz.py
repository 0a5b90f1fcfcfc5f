"""Deterministic random-DFG generation for the differential test harness.

The fuzz suite (``tests/test_differential.py``, DESIGN.md §14.5) needs a
stream of small, *valid* DFGs that exercise every structural feature the
mapper handles — fan-out, reconvergence, loop-carried recurrences, memory
ops, multiplies — without ever producing an input ``DFG.validate`` would
reject. ``hypothesis`` is not available in the container, so generation is
a plain seeded :class:`random.Random` walk: ``random_dfg(seed)`` is a pure
function of its arguments, which makes every fuzz failure replayable from
the seed printed in the test id.

Construction invariants (each is load-bearing for validity):

* Intra-iteration edges only go ``src < dst`` — the distance-0 subgraph is
  a DAG by construction, never by rejection sampling.
* Ops are assigned *after* wiring, from the node's final in-degree, so the
  ``OP_ARITY`` check can't fire: 0 → ``input``/``const``, 1 → unary pool
  (including ``load``/``store`` for memory pressure), 2 → binary pool.
* Loop-carried edges have ``distance ≥ 1`` and respect the in-degree cap,
  so ``rec_ii`` is always finite and arity still holds.
"""

from __future__ import annotations

import random

from .dfg import DFG, Edge

__all__ = ["random_dfg"]

_NULLARY = ("input", "const")
_UNARY = ("neg", "not", "abs", "mov")
_UNARY_MEM = ("load", "store")
_BINARY = ("add", "sub", "and", "or", "xor", "shl", "shr", "min", "max", "cmp")
_BINARY_MUL = ("mul",)


def random_dfg(
    seed: int,
    *,
    min_nodes: int = 4,
    max_nodes: int = 10,
    p_second_operand: float = 0.55,
    p_carried: float = 0.35,
    p_mem: float = 0.25,
    p_mul: float = 0.15,
    name: str | None = None,
) -> DFG:
    """One valid random DFG, a pure function of ``seed`` and the knobs.

    ``p_second_operand`` drives reconvergence (two distinct predecessors),
    ``p_carried`` the chance of each of up to two loop-carried back edges,
    ``p_mem``/``p_mul`` the per-candidate chance of drawing from the memory
    and multiplier pools (exercising capability classes on heterogeneous
    fabrics). The result always passes ``DFG.validate()``.
    """
    rng = random.Random(seed)
    n = rng.randint(min_nodes, max_nodes)
    in_deg = [0] * n
    edges: list[Edge] = []

    # Forward wiring: every non-root node consumes at least one earlier
    # node (keeps the graph connected enough to be interesting), and with
    # probability p_second_operand a second, distinct one.
    for v in range(1, n):
        u = rng.randrange(v)
        edges.append(Edge(u, v))
        in_deg[v] = 1
        if v >= 2 and rng.random() < p_second_operand:
            w = rng.randrange(v)
            if w != u:
                edges.append(Edge(w, v))
                in_deg[v] = 2

    # Loop-carried back edges: distance >= 1 keeps rec_ii finite even when
    # src >= dst closes a cycle; the in-degree cap keeps arity valid.
    for _ in range(2):
        if rng.random() >= p_carried:
            continue
        dst = rng.randrange(n)
        if in_deg[dst] >= 2:
            continue
        src = rng.randrange(n)
        dist = rng.randint(1, 2)
        edges.append(Edge(src, dst, distance=dist))
        in_deg[dst] += 1

    ops = []
    for v in range(n):
        if in_deg[v] == 0:
            ops.append(rng.choice(_NULLARY))
        elif in_deg[v] == 1:
            if rng.random() < p_mem:
                ops.append(rng.choice(_UNARY_MEM))
            else:
                ops.append(rng.choice(_UNARY))
        else:
            if rng.random() < p_mul:
                ops.append(rng.choice(_BINARY_MUL))
            else:
                ops.append(rng.choice(_BINARY))

    dfg = DFG(
        num_nodes=n,
        edges=edges,
        ops=ops,
        name=name or f"fuzz_{seed}",
        imms=[float(rng.randint(-8, 8)) for _ in range(n)],
    )
    dfg.validate()  # raises on a generator bug — invariants above prevent it
    return dfg
