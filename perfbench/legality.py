"""The plain legality checker of a mapping, and mII, on a mesh fabric.

The machine model of DESIGN.md §2: an R x C grid of single-cycle PEs, each
reading its own and its mesh neighbours' register files, where a value stays
in its producer's register file. A mapping (II, t_abs, placement) of a DFG
is legal when

* every node sits on a PE of the fabric at a time >= 0;
* no two nodes share a PE at the same kernel step (t mod II);
* every edge u -> v of distance d has t_v >= t_u + 1 - II * d;
* every edge joins closed-adjacent PEs (the same PE or a mesh neighbour);
* (strict connectivity, DESIGN.md §7) no node has more DFG neighbours at one
  kernel step than its closed neighbourhood holds, less its own PE at its
  own step.

mII = max(ResII, RecII): ResII = ceil(nodes / PEs) on a homogeneous fabric,
RecII the least II at which the dependence constraints have no positive
cycle. Nothing here imports the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .reference import PlainDFG


@dataclass(frozen=True)
class Mesh:
    """A homogeneous R x C mesh; PE id = row * cols + col."""

    rows: int
    cols: int

    @property
    def num_pes(self) -> int:
        return self.rows * self.cols

    def closed_adjacent(self, p: int, q: int) -> bool:
        (pr, pc), (qr, qc) = divmod(p, self.cols), divmod(q, self.cols)
        return abs(pr - qr) + abs(pc - qc) <= 1

    def closed_degree(self) -> int:
        """The largest closed neighbourhood (D_M): 5 from 3 x 3 up."""
        return max(1 + (r > 0) + (r < self.rows - 1) + (c > 0) + (c < self.cols - 1)
                   for r in range(self.rows) for c in range(self.cols))


def res_ii(dfg: PlainDFG, mesh: Mesh) -> int:
    return math.ceil(dfg.num_nodes / mesh.num_pes)


def _feasible(dfg: PlainDFG, ii: int) -> bool:
    """No positive cycle under t_dst >= t_src + 1 - ii * distance."""
    dist = [0] * dfg.num_nodes
    for _ in range(dfg.num_nodes + 1):
        changed = False
        for s, d, k, _ in dfg.edges:
            w = dist[s] + 1 - ii * k
            if w > dist[d]:
                dist[d] = w
                changed = True
        if not changed:
            return True
    return False


def rec_ii(dfg: PlainDFG) -> int:
    ii = 1
    while not _feasible(dfg, ii):
        ii += 1
        if ii > dfg.num_nodes + 1:
            raise ValueError(f"{dfg.name}: a zero-distance cycle has no RecII")
    return ii


def min_ii(dfg: PlainDFG, mesh: Mesh) -> int:
    return max(res_ii(dfg, mesh), rec_ii(dfg))


def violations(dfg: PlainDFG, mesh: Mesh, ii: int, t_abs, placement) -> list[str]:
    """Every broken rule of the mapping (empty when it is legal)."""
    n = dfg.num_nodes
    if ii < 1:
        return [f"II {ii} < 1"]
    if len(t_abs) != n or len(placement) != n:
        return [f"{len(t_abs)} times and {len(placement)} PEs for {n} nodes"]
    errs = []
    slot: dict[tuple[int, int], int] = {}
    for v in range(n):
        if not 0 <= placement[v] < mesh.num_pes:
            errs.append(f"node {v} on PE {placement[v]}, off the fabric")
        if t_abs[v] < 0:
            errs.append(f"node {v} at time {t_abs[v]}")
        key = (placement[v], t_abs[v] % ii)
        if key in slot:
            errs.append(f"nodes {slot[key]} and {v} share PE {key[0]} at step {key[1]}")
        slot[key] = v
    if errs:
        return errs
    neighbours: list[set[int]] = [set() for _ in range(n)]
    for s, d, k, _ in dfg.edges:
        if t_abs[d] < t_abs[s] + 1 - ii * k:
            errs.append(f"edge {s}->{d} (distance {k}) read before it is produced")
        if not mesh.closed_adjacent(placement[s], placement[d]):
            errs.append(f"edge {s}->{d} joins PEs {placement[s]} and {placement[d]}, "
                        "not adjacent")
        if s != d:
            neighbours[s].add(d)
            neighbours[d].add(s)
    d_m = mesh.closed_degree()
    for v in range(n):
        per_step: dict[int, int] = {}
        for u in neighbours[v]:
            per_step[t_abs[u] % ii] = per_step.get(t_abs[u] % ii, 0) + 1
        for step, count in per_step.items():
            limit = d_m - 1 if step == t_abs[v] % ii else d_m
            if count > limit:
                errs.append(f"node {v}: {count} neighbours at step {step} > {limit}")
    return errs
