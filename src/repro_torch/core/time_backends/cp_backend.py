"""Incremental pure-Python CP time backend (DESIGN.md §4.2).

Two-level decomposition of the time phase that enumerates each *kernel-label
partition at most once* — the property the space phase actually needs:

  Level 1 — label search. DFS over per-node kernel labels ``k_v`` (domains =
  the residues ``t mod II`` reachable inside the node's modulo-aware
  [asap, alap] window) with the paper's capacity + connectivity constraints,
  the strict same-step bound, the bipartite-triangle cut, and a necessary
  per-edge realizability bound. The DFS keeps a *persistent trail* (explicit
  decision stack) across ``next_solution()`` calls: enumeration resumes from
  the last decision instead of re-solving from scratch, and blocking a
  returned partition is implicit — the DFS simply never revisits a label
  tuple. External blocking clauses (mapper-level rejects) are honoured via a
  blocked set consulted before a complete assignment is realized.

  Level 2 — fold realization. Given a complete label assignment, the
  dependency constraints ``t_dst >= t_src + 1 - II*distance`` restricted to
  ``t_v ≡ k_v (mod II)`` form a monotone difference-constraint system over
  finite domains; its least fixpoint (Bellman-Ford with congruence rounding)
  either yields the minimal consistent ``t_abs`` or proves the partition
  admits no schedule — no search needed, so realization is polynomial.

The old generator backend enumerated raw ``t_abs`` assignments, re-proposing
the same partition many times (once per fold combination) and carrying no
state between mapper retries; this one is both incremental and partition-deduplicated.
"""

from __future__ import annotations

import random
import time as _time

from .base import TimeProblem, register_backend, residue_window, triangles


class IncrementalCPBackend:
    name = "cp-inc"
    exhausted: bool

    def __init__(self, problem: TimeProblem, *, timeout_s: float | None = None):
        p = self.p = problem
        self.timeout_s = timeout_s
        n, ii = p.num_nodes, p.ii
        self.exhausted = False
        # observational telemetry (DESIGN.md §15): cumulative decision steps
        # and partition realizations across every next_solution() call —
        # read via getattr by TimeSolver, never consulted by the search
        self.steps_total = 0
        self.realizations = 0
        self._blocked: set[tuple[int, ...]] = set()

        # per-(node, residue) min/max absolute time inside the window
        self._tmin: list[dict[int, int]] = []
        self._tmax: list[dict[int, int]] = []
        domains: list[list[int]] = []
        for v in range(n):
            lo, hi = p.asap[v], p.alap[v]
            tmin: dict[int, int] = {}
            tmax: dict[int, int] = {}
            for k in range(ii):
                win = residue_window(lo, hi, k, ii)
                if win is not None:
                    tmin[k], tmax[k] = win
            self._tmin.append(tmin)
            self._tmax.append(tmax)
            domains.append(sorted(tmin, key=lambda k: tmin[k]))

        # static variable order: most-constrained first (smallest label
        # domain, then highest degree) — mirrors the old generator's ordering
        self._order = sorted(
            range(n), key=lambda v: (len(domains[v]), -len(p.adj[v]))
        )
        # value order: earliest-feasible-first on the first solve (greedy,
        # matches ASAP-style packing); seeded shuffle for retry diversity
        if p.seed:
            rng = random.Random(p.seed)
            for dom in domains:
                rng.shuffle(dom)
        self._domains = domains

        self._adj = [sorted(s) for s in p.adj]
        self._edges = list(p.edges)
        self._labels = [-1] * n
        self._count_per_step = [0] * ii
        # per-capability-class occupancy (heterogeneous grids, DESIGN.md §10):
        # class ci keeps its own per-step counter next to the global one
        self._cls_cap = [cap_c for _name, cap_c, _m in p.class_caps]
        self._cls_count = [[0] * ii for _ in p.class_caps]
        self._cls_of: list[tuple[int, ...]] = [()] * n
        for ci, (_name, _cap_c, members) in enumerate(p.class_caps):
            for v in members:
                self._cls_of[v] = self._cls_of[v] + (ci,)
        # triangle cut only matters in strict mode and only for nodes in one
        self._tri_of: list[list[tuple[int, int]]] = [[] for _ in range(n)]
        if p.strict and p.triangle_free:
            for u, v, w in triangles(p.adj):
                self._tri_of[u].append((v, w))
                self._tri_of[v].append((u, w))
                self._tri_of[w].append((u, v))
        # persistent trail: (node, index-into-domain) per decision
        self._trail: list[tuple[int, int]] = []
        self._pending = 0   # value index to resume from at the current depth

    # ------------------------------------------------------------- search
    def block(self, labels: list[int]) -> None:
        self._blocked.add(tuple(labels))

    def next_solution(
        self, *, deadline: float | None = None, step_budget: int | None = None
    ) -> list[int] | None:
        if self.exhausted:
            return None
        if self.timeout_s is not None:
            cap = _time.perf_counter() + self.timeout_s
            deadline = cap if deadline is None else min(deadline, cap)
        p = self.p
        n = p.num_nodes
        # re-entry after a yielded solution: step past it
        if len(self._trail) == n:
            self._backtrack()
            if self.exhausted:
                return None
        steps = 0
        while True:
            depth = len(self._trail)
            if depth == n:
                labels = tuple(self._labels)
                if labels not in self._blocked:
                    self.realizations += 1
                    t_abs = self._realize()
                    if t_abs is not None:
                        return t_abs
                self._backtrack()
                if self.exhausted:
                    return None
                continue
            steps += 1
            self.steps_total += 1
            if step_budget is not None and steps > step_budget:
                return None  # trail kept: resumable
            if deadline is not None and not steps & 0x3F:
                if _time.perf_counter() > deadline:
                    return None
            v = self._order[depth]
            dom = self._domains[v]
            start, self._pending = self._pending, 0
            placed = False
            for idx in range(start, len(dom)):
                k = dom[idx]
                if self._consistent(v, k):
                    self._trail.append((v, idx))
                    self._labels[v] = k
                    self._count_per_step[k] += 1
                    for ci in self._cls_of[v]:
                        self._cls_count[ci][k] += 1
                    placed = True
                    break
            if not placed:
                self._backtrack()
                if self.exhausted:
                    return None

    def _backtrack(self) -> None:
        while self._trail:
            v, idx = self._trail.pop()
            k = self._labels[v]
            self._count_per_step[k] -= 1
            for ci in self._cls_of[v]:
                self._cls_count[ci][k] -= 1
            self._labels[v] = -1
            if idx + 1 < len(self._domains[v]):
                self._pending = idx + 1
                return
        self.exhausted = True

    # -------------------------------------------------------- constraints
    def _consistent(self, v: int, k: int) -> bool:
        p = self.p
        ii = p.ii
        labels = self._labels
        if self._count_per_step[k] >= p.cap:
            return False
        for ci in self._cls_of[v]:
            if self._cls_count[ci][k] >= self._cls_cap[ci]:
                return False
        strict = p.strict
        d_m = p.d_m
        # connectivity of v: assigned neighbours bucketed by step
        per_step: dict[int, int] = {}
        for u in self._adj[v]:
            lu = labels[u]
            if lu >= 0:
                per_step[lu] = per_step.get(lu, 0) + 1
        if per_step.get(k, 0) > (d_m - 1 if strict else d_m):
            return False
        for cnt in per_step.values():
            if cnt > d_m:
                return False
        # v's assignment adds one to each assigned neighbour's step-k count
        for u in self._adj[v]:
            lu = labels[u]
            if lu < 0:
                continue
            cu = 1
            for w in self._adj[u]:
                if w != v and labels[w] == k:
                    cu += 1
            limit = d_m - 1 if strict and lu == k else d_m
            if cu > limit:
                return False
        if strict and self._tri_of[v]:
            for a, b in self._tri_of[v]:
                if labels[a] == k and labels[b] == k:
                    return False
        # per-edge realizability (necessary): some fold pair must satisfy the
        # dependency once both endpoints' residues are fixed
        tmin_v = self._tmin[v][k]
        tmax_v = self._tmax[v][k]
        for src, dst, dist in self._edges:
            if src == v and labels[dst] >= 0:
                if self._tmax[dst][labels[dst]] < tmin_v + 1 - ii * dist:
                    return False
            elif dst == v and labels[src] >= 0:
                if tmax_v < self._tmin[src][labels[src]] + 1 - ii * dist:
                    return False
        return True

    # -------------------------------------------------------- realization
    def _realize(self) -> list[int] | None:
        """Least fixpoint of the difference constraints within residue classes."""
        p = self.p
        ii = p.ii
        labels = self._labels
        lb = [self._tmin[v][labels[v]] for v in range(p.num_nodes)]
        ub = [self._tmax[v][labels[v]] for v in range(p.num_nodes)]
        changed = True
        while changed:
            changed = False
            for src, dst, dist in self._edges:
                bound = lb[src] + 1 - ii * dist
                if lb[dst] < bound:
                    t = bound + ((labels[dst] - bound) % ii)
                    if t > ub[dst]:
                        return None
                    lb[dst] = t
                    changed = True
        return lb


def _available() -> bool:
    return True


register_backend("cp", IncrementalCPBackend, _available, aliases=("python", "cp-inc"))
