"""Z3 SMT time backend — the paper-faithful encoding (DESIGN.md §4.1).

Integer variables t_v with the linear decomposition t = II*fold + k (Z3
handles this far better than the `mod` operator on small grids), pseudo-
boolean capacity/connectivity constraints, and label-partition blocking
clauses after each model so the mapper's retry loop converges quickly.
"""

from __future__ import annotations

import time as _time

from .base import TimeProblem, register_backend, triangles

try:  # pragma: no cover - availability probed at import
    import z3  # type: ignore

    HAVE_Z3 = True
except Exception:  # pragma: no cover
    z3 = None
    HAVE_Z3 = False


class Z3Backend:
    name = "z3"
    exhausted: bool

    def __init__(self, problem: TimeProblem, *, timeout_s: float | None = None):
        if not HAVE_Z3:  # pragma: no cover
            raise RuntimeError("z3 backend requested but z3 is not importable")
        p = self.p = problem
        self.timeout_s = timeout_s
        self.exhausted = False
        self._solutions = 0
        # observational telemetry (DESIGN.md §15): one "step" per solver
        # check() call — the closest z3 analogue to the cp backend's
        # decision-step counter; read via getattr by TimeSolver
        self.steps_total = 0
        n, ii = p.num_nodes, p.ii
        self._solver = z3.Solver()
        if timeout_s is not None:
            self._solver.set("timeout", int(timeout_s * 1000))
        self._solver.set("random_seed", p.seed & 0xFFFF)
        self._t = [z3.Int(f"t_{v}") for v in range(n)]
        self._k = [z3.Int(f"k_{v}") for v in range(n)]
        self._f = [z3.Int(f"f_{v}") for v in range(n)]
        s = self._solver
        max_fold = max(p.alap) // ii + 1 if n else 1
        for v in range(n):
            s.add(self._t[v] >= p.asap[v], self._t[v] <= p.alap[v])
            s.add(self._t[v] == ii * self._f[v] + self._k[v])
            s.add(self._k[v] >= 0, self._k[v] < ii)
            s.add(self._f[v] >= 0, self._f[v] <= max_fold)
        # 1. modulo-scheduling constraints
        for src, dst, dist in p.edges:
            s.add(self._t[dst] >= self._t[src] + 1 - ii * dist)
        # 2. capacity constraints — global, then per capability class on
        # heterogeneous grids (only classes with capacity < cap are present)
        for i in range(ii):
            s.add(z3.PbLe([(self._k[v] == i, 1) for v in range(n)], p.cap))
        for _cls, cap_c, members in p.class_caps:
            for i in range(ii):
                s.add(z3.PbLe([(self._k[v] == i, 1) for v in members], cap_c))
        # 3. connectivity constraints
        for v in range(n):
            nbrs = sorted(p.adj[v])
            if not nbrs:
                continue
            for i in range(ii):
                s.add(z3.PbLe([(self._k[u] == i, 1) for u in nbrs], p.d_m))
            if p.strict:
                # same-step neighbours can only use the open neighbourhood
                s.add(
                    z3.PbLe(
                        [(self._k[u] == self._k[v], 1) for u in nbrs], p.d_m - 1
                    )
                )
        if p.strict and p.triangle_free:
            # triangle-free PE graph => no mono-chromatic triangle (DESIGN.md
            # §7); unsound on diagonal/one-hop grids, hence the gate
            for u, v, w in triangles(p.adj):
                s.add(z3.Or(self._k[u] != self._k[v], self._k[u] != self._k[w]))

    def block(self, labels: list[int]) -> None:
        n = self.p.num_nodes
        self._solver.add(
            z3.Or([self._k[v] != labels[v] for v in range(n)])
        )

    def next_solution(
        self, *, deadline: float | None = None, step_budget: int | None = None
    ) -> list[int] | None:
        if self.exhausted:
            return None
        if deadline is not None:
            ms = int(max(0.001, deadline - _time.perf_counter()) * 1000)
            self._solver.set("timeout", ms)
        else:
            # per-call deadlines must not leak into later unbounded calls
            self._solver.set(
                "timeout",
                int(self.timeout_s * 1000) if self.timeout_s is not None else 0,
            )
        self.steps_total += 1
        res = self._solver.check()
        if res == z3.unsat:
            self.exhausted = True
            return None
        if res != z3.sat:  # unknown: budget ran out, resumable
            return None
        model = self._solver.model()
        n = self.p.num_nodes
        t_abs = [model.eval(self._t[v]).as_long() for v in range(n)]
        # Block the *label partition*, not just this t_abs: the space search
        # depends only on labels, so any schedule with the same labels would
        # fail the same way.
        self.block([t % self.p.ii for t in t_abs])
        if self._solutions == 0:
            # Retry solves want *structurally* diverse label partitions (the
            # first solve wants fast default heuristics) — flip to randomised
            # phase selection once retries begin.
            try:
                self._solver.set("phase_selection", 5)
            except z3.Z3Exception:  # pragma: no cover
                pass
        self._solutions += 1
        return t_abs


def _available() -> bool:
    return HAVE_Z3


register_backend("z3", Z3Backend, _available)
