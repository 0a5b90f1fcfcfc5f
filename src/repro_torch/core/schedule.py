"""ASAP/ALAP/Mobility/Kernel-Mobility schedules and mII (paper §III-B, §IV-B).

All ops are single-cycle (the paper's machine model). ASAP/ALAP are computed on
the intra-iteration (acyclic) subgraph; loop-carried dependencies enter later
as modulo constraints in the SMT formulation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .cgra import CGRA
from .dfg import DFG


def asap_schedule(dfg: DFG) -> list[int]:
    order = _topo_order(dfg)
    t = [0] * dfg.num_nodes
    for v in order:
        for e in dfg.predecessors(v, carried=False):
            t[v] = max(t[v], t[e.src] + 1)
    return t


def alap_schedule(dfg: DFG, length: int | None = None) -> list[int]:
    asap = asap_schedule(dfg)
    horizon = length if length is not None else max(asap, default=0)
    t = [horizon] * dfg.num_nodes
    for v in reversed(_topo_order(dfg)):
        for e in dfg.successors(v, carried=False):
            t[v] = min(t[v], t[e.dst] - 1)
    if any(t[v] < asap[v] for v in dfg.nodes):
        raise ValueError("ALAP horizon shorter than critical path")
    return t


@dataclass(frozen=True)
class MobilitySchedule:
    """MobS: per time step, the set of nodes whose [asap, alap] covers it."""

    asap: tuple[int, ...]
    alap: tuple[int, ...]

    @property
    def length(self) -> int:
        return max(self.alap, default=0) + 1

    def rows(self) -> list[list[int]]:
        return [
            [v for v in range(len(self.asap)) if self.asap[v] <= t <= self.alap[v]]
            for t in range(self.length)
        ]

    def mobility(self, v: int) -> int:
        return self.alap[v] - self.asap[v]


def mobility_schedule(dfg: DFG) -> MobilitySchedule:
    return MobilitySchedule(tuple(asap_schedule(dfg)), tuple(alap_schedule(dfg)))


@dataclass(frozen=True)
class KMS:
    """Kernel Mobility Schedule: MobS folded by II (paper §IV-B).

    Entry (v, it) at kernel row t means node v of fold/iteration ``it`` may be
    scheduled at kernel step t, i.e. at absolute time ``t + it*II`` within the
    MobS window. The KMS is the superset of all schedules for a given II.
    """

    mobs: MobilitySchedule
    ii: int

    @property
    def num_folds(self) -> int:
        return math.ceil(self.mobs.length / self.ii)

    def rows(self) -> list[list[tuple[int, int]]]:
        out: list[list[tuple[int, int]]] = [[] for _ in range(self.ii)]
        for t, row in enumerate(self.mobs.rows()):
            fold, kt = divmod(t, self.ii)
            out[kt].extend((v, fold) for v in row)
        return out

    def slots(self, v: int) -> list[tuple[int, int]]:
        """All (kernel_step, fold) options for node v."""
        return [
            divmod(t, self.ii)[::-1]
            for t in range(self.mobs.asap[v], self.mobs.alap[v] + 1)
        ]


def modulo_windows(
    dfg: DFG, ii: int, horizon: int
) -> tuple[list[int], list[int]] | None:
    """Modulo-aware [asap, alap] windows (iterative-modulo-scheduling style).

    Every edge (u→v, distance d) imposes t_v >= t_u + 1 - II*d, including the
    loop-carried ones the plain DAG ASAP/ALAP ignore. Longest-path fixpoints
    over this cyclic constraint graph (Bellman-Ford; no positive cycles when
    II >= RecII) tighten the windows substantially for recurrence-heavy DFGs,
    shrinking the SMT encoding. Returns None if infeasible at this (II,
    horizon) — a free UNSAT proof.
    """
    n = dfg.num_nodes
    asap = asap_schedule(dfg)
    try:
        alap = alap_schedule(dfg, length=horizon)
    except ValueError:
        return None
    for _ in range(n + 1):
        changed = False
        for e in dfg.edges:
            lo = asap[e.src] + 1 - ii * e.distance
            if lo > asap[e.dst]:
                asap[e.dst] = lo
                changed = True
            hi = alap[e.dst] - 1 + ii * e.distance
            if hi < alap[e.src]:
                alap[e.src] = hi
                changed = True
        if not changed:
            break
    else:
        return None  # still changing after n rounds: positive cycle (II < RecII)
    if any(asap[v] > alap[v] for v in range(n)):
        return None
    return asap, alap


def res_ii(dfg: DFG, cgra: CGRA) -> int:
    """ResII = ceil(|V_G| / |PEs|), sharpened per capability class.

    On heterogeneous grids each op class only has ``class_capacity`` slots
    per kernel step (mem additionally bounded by the port count), so
    ResII = max over classes of ceil(|class members| / capacity) — the
    paper's scalar bound is the homogeneous special case. A class with no
    capable PEs is the mapper's fail-fast territory
    (``CGRA.unsupported_ops``), not a finite ResII; it is skipped here.
    """
    base = math.ceil(dfg.num_nodes / cgra.num_pes)
    if cgra.heterogeneous:
        from .cgra import op_class

        members: dict[str, int] = {}
        for v in dfg.nodes:
            cls = op_class(dfg.ops[v])
            members[cls] = members.get(cls, 0) + 1
        for cls, n in members.items():
            cap = cgra.class_capacity(cls)
            if cap > 0:
                base = max(base, math.ceil(n / cap))
    return base


def rec_ii(dfg: DFG) -> int:
    """RecII = max over dependence cycles of ceil(length/distance)."""
    return dfg.rec_ii()


def min_ii(dfg: DFG, cgra: CGRA) -> int:
    return max(res_ii(dfg, cgra), rec_ii(dfg))


def _topo_order(dfg: DFG) -> list[int]:
    indeg = [0] * dfg.num_nodes
    adj: list[list[int]] = [[] for _ in dfg.nodes]
    for e in dfg.intra_edges():
        adj[e.src].append(e.dst)
        indeg[e.dst] += 1
    stack = [v for v in dfg.nodes if indeg[v] == 0]
    order: list[int] = []
    while stack:
        v = stack.pop()
        order.append(v)
        for w in adj[v]:
            indeg[w] -= 1
            if indeg[w] == 0:
                stack.append(w)
    if len(order) != dfg.num_nodes:
        raise ValueError(f"{dfg.name}: cyclic intra-iteration dependencies")
    return order
