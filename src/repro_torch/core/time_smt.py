"""Time-dimension solver facade (paper §IV-B).

Finds a modulo schedule (an absolute time ``t_v`` per DFG node, equivalently a
kernel label ``l(v) = t_v mod II`` plus fold ``it_v = t_v div II``) satisfying
three constraint families:

1. *Modulo-scheduling constraints* — dependency ordering across foldings. We
   encode the standard absolute-time form ``t_dst >= t_src + 1 - II*distance``,
   which is exactly the paper's KMS case split (``t_d > t_s`` when
   ``it_s == it_d``; ``t_d <= t_s`` when ``it_s - it_d == 1``) expressed without
   the case analysis.
2. *Capacity constraints* (paper's addition) — per kernel step i, the number of
   nodes labelled i must not exceed the PE count. On heterogeneous grids
   (core/arch, DESIGN.md §10) the scalar bound is joined by one cardinality
   constraint per capability class whose capacity is below the PE count: at
   most ``class_capacity(cls)`` nodes of class ``cls`` per step (memory ops
   additionally clamped by the grid's port count).
3. *Connectivity constraints* (paper's addition) — for every node v and step i,
   the number of DFG-neighbours of v labelled i must not exceed the CGRA
   connectivity degree D_M (closed neighbourhood size).

``connectivity="paper"`` reproduces the constraint exactly as published.
``connectivity="strict"`` additionally requires, for neighbours scheduled at
*v's own* step, a bound of D_M - 1: same-step injectivity means v's own PE is
not available to its same-step neighbours. The published proof overlooks this
(see DESIGN.md §7 and tests/test_theorem.py, which exhibits the gap); "strict"
closes the common case, and the mapper additionally retries with blocking
clauses whenever a time solution admits no monomorphism, which makes the
overall pipeline complete regardless of mode.

The actual solving is delegated to the backend subsystem
(core/time_backends/): "z3" is the paper-faithful SMT encoding, "cp" (alias
"python") the dependency-free incremental CP engine, "auto" picks z3 when
importable. ``TimeSolver.stats.backend`` always reports the concrete backend
that ran — never the alias that was asked for.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

from .. import obs
from .cgra import CGRA
from .dfg import DFG
from .schedule import MobilitySchedule, asap_schedule, modulo_windows
from .time_backends import (
    TimeProblem,
    available_backends,
    create_backend,
    resolve_backend_name,
)
from .time_backends.base import residue_window
from .time_backends.z3_backend import HAVE_Z3  # re-exported for callers/tests

__all__ = [
    "TimeSolution",
    "TimeSolver",
    "TimeSolverStats",
    "check_time_solution",
    "available_backends",
    "HAVE_Z3",
]


@dataclass
class TimeSolution:
    """A valid time solution: absolute times + derived kernel labels."""

    ii: int
    t_abs: list[int]

    @property
    def labels(self) -> list[int]:
        return [t % self.ii for t in self.t_abs]

    @property
    def folds(self) -> list[int]:
        return [t // self.ii for t in self.t_abs]


@dataclass
class TimeSolverStats:
    solver_time_s: float = 0.0
    num_solutions_enumerated: int = 0
    backend: str = ""
    blocked: int = 0
    steps: int = 0          # cumulative backend search steps / solver calls


class TimeSolver:
    """Lazily enumerates time solutions for one (dfg, cgra, II, slack) window.

    ``next_solution()`` returns a fresh :class:`TimeSolution` each call — each
    with a *label partition* (the multiset of kernel steps ``t mod II``) never
    proposed before — or None when either the per-call budget ran out
    (``solver.exhausted`` False: call again to resume) or the window is proven
    empty (``solver.exhausted`` True). The portfolio mapper uses this to
    recover from monomorphism failures: a partition that failed to embed is
    never re-proposed (DESIGN.md §4), and ``block(labels)`` excludes one
    externally (e.g. on a register-pressure reject).

    Example — enumerate two distinct partitions for the running example::

        from repro_torch.core import CGRA, TimeSolver, running_example

        solver = TimeSolver(running_example(), CGRA(2, 2), ii=4, backend="cp")
        a = solver.next_solution()
        b = solver.next_solution()
        assert sorted(a.labels) != sorted(b.labels) or a.labels != b.labels
        assert max(a.folds) >= 1        # 14 nodes fold over 4 kernel steps

    Raises ``ValueError`` at construction when the window is infeasible by
    analytic precheck (modulo-window collapse, degree/supply bounds) — a free
    UNSAT proof the mapper consumes to mark the window dead (DESIGN.md §3).
    """

    def __init__(
        self,
        dfg: DFG,
        cgra: CGRA,
        ii: int,
        *,
        extra_slack: int = 0,
        connectivity: str = "strict",
        backend: str = "auto",
        timeout_s: float | None = None,
        seed: int = 0,
        route_hops: int = 0,
    ) -> None:
        """``route_hops > 0`` relaxes the connectivity constraint family to
        the route-through regime (DESIGN.md §12.3): with up to ``route_hops``
        mov insertions per edge, a neighbour only needs to sit within the
        closed ``1 + route_hops``-step reach of a PE, so D_M is replaced by
        ``cgra.reach_degree(1 + route_hops)`` in the prechecks and backend
        constraints, and the strict-mode triangle exclusion is dropped (three
        mutually adjacent nodes *can* share a step once edges may ride mov
        chains). ``route_hops=0`` is bit-identical to the historical solver.
        """
        if connectivity not in ("paper", "strict"):
            raise ValueError(connectivity)
        if route_hops < 0:
            raise ValueError(f"route_hops must be >= 0, got {route_hops}")
        self.dfg = dfg
        self.cgra = cgra
        self.ii = ii
        self.seed = seed
        self.connectivity = connectivity
        self.timeout_s = timeout_s
        self.stats = TimeSolverStats()
        horizon = max(asap_schedule(dfg), default=0) + extra_slack
        windows = modulo_windows(dfg, ii, horizon)
        if windows is None:
            # infeasible window: expose an exhausted solver
            raise ValueError(f"II={ii} infeasible within horizon {horizon}")
        self.asap, self.alap = windows
        # Analytic connectivity prechecks (save the backends from exponential
        # PB-UNSAT proofs on high-fanout DFGs):
        #  (a) degree bound: deg(v) <= D_M*II - 1 (closed nbhd x steps - own slot)
        #  (b) window-aware: neighbours can only occupy kernel steps their
        #      [asap, alap] windows reach; per-step supply is capped at D_M
        #      (D_M - 1 at v's own step when v's window is a singleton).
        d_m = (cgra.connectivity_degree if route_hops == 0
               else cgra.reach_degree(1 + route_hops))
        for v, nbrs in enumerate(dfg.undirected_adjacency()):
            if not nbrs:
                continue
            if len(nbrs) > d_m * ii - 1:
                raise ValueError(
                    f"II={ii} infeasible: node {v} degree {len(nbrs)} > {d_m}*II-1"
                )
            cand = [0] * ii
            for u in nbrs:
                span = range(self.asap[u], min(self.alap[u], self.asap[u] + ii - 1) + 1)
                for k in {t % ii for t in span}:
                    cand[k] += 1
            v_span = {t % ii for t in range(self.asap[v], min(self.alap[v], self.asap[v] + ii - 1) + 1)}
            supply = sum(
                min(cand[k], d_m - (1 if (len(v_span) == 1 and k in v_span) else 0))
                for k in range(ii)
            )
            if supply < len(nbrs):
                raise ValueError(
                    f"II={ii} infeasible: node {v} neighbour supply {supply} < "
                    f"{len(nbrs)}"
                )
        # Per-op-class capacity (heterogeneous grids): emit one cardinality
        # constraint per class that is strictly tighter than the global PE
        # bound, with a free per-window UNSAT precheck — a class with more
        # members than capacity*II can never fit this window.
        class_caps: list[tuple[str, int, tuple[int, ...]]] = []
        if cgra.heterogeneous:
            from .cgra import op_class

            members: dict[str, list[int]] = {}
            for v in dfg.nodes:
                members.setdefault(op_class(dfg.ops[v]), []).append(v)
            for cls, nodes in sorted(members.items()):
                cap = cgra.class_capacity(cls)
                if cap >= cgra.num_pes:
                    continue
                if len(nodes) > cap * ii:
                    raise ValueError(
                        f"II={ii} infeasible: {len(nodes)} {cls!r} ops > "
                        f"capacity {cap} x II"
                    )
                class_caps.append((cls, cap, tuple(nodes)))
        self.mobs = MobilitySchedule(tuple(self.asap), tuple(self.alap))
        self.adj = dfg.undirected_adjacency()
        problem = TimeProblem(
            num_nodes=dfg.num_nodes,
            edges=tuple((e.src, e.dst, e.distance) for e in dfg.edges),
            adj=tuple(frozenset(s) for s in self.adj),
            ii=ii,
            asap=tuple(self.asap),
            alap=tuple(self.alap),
            cap=cgra.num_pes,
            d_m=d_m,
            strict=connectivity == "strict",
            seed=seed,
            class_caps=tuple(class_caps),
            triangle_free=cgra.triangle_free and route_hops == 0,
        )
        self.backend = resolve_backend_name(backend)
        self._engine = create_backend(self.backend, problem, timeout_s=timeout_s)
        self.stats.backend = self._engine.name

    @property
    def exhausted(self) -> bool:
        return self._engine.exhausted

    def block(self, labels: list[int]) -> None:
        """Externally exclude a label partition (e.g. register-pressure reject)."""
        self._engine.block(labels)
        self.stats.blocked += 1

    def realize_compact(
        self, sol: TimeSolution, *, nodes=None
    ) -> TimeSolution:
        """Lifetime-compacting re-realization of ``sol``'s label partition.

        Backends return the *minimal* schedule for a partition (every node as
        early as its window and residue allow), which maximises
        producer-to-consumer gaps and therefore register lifetimes. This pass
        keeps every sink at its minimal time but pushes every producer as
        late as its consumers permit (greatest fixpoint of the difference
        constraints, floor-rounded to each node's residue class) — same
        labels, same validity, shorter lifetimes. Used by the mapper's
        register-pressure-constrained retries (paper §V-3 extension).

        ``nodes`` restricts the push to a subset (the mapper passes the nodes
        placed on register-oversubscribed PEs so only the offending PEs'
        schedules move); everything else keeps its time from ``sol``, which
        stays valid because the fixpoint is pointwise >= ``sol``.
        """
        ii = self.ii
        labels = sol.labels
        n = self.dfg.num_nodes
        movable = set(range(n)) if nodes is None else set(nodes)
        has_succ = [False] * n
        for e in self.dfg.edges:
            if e.src != e.dst:
                has_succ[e.src] = True
        ub: list[int] = []
        for v in range(n):
            if not has_succ[v] or v not in movable:
                ub.append(sol.t_abs[v])     # sinks (and unselected nodes) stay
                continue
            win = residue_window(self.asap[v], self.alap[v], labels[v], ii)
            assert win is not None          # sol.t_abs[v] inhabits the class
            ub.append(win[1])
        t = list(ub)
        changed = True
        while changed:
            changed = False
            for e in self.dfg.edges:
                bound = t[e.dst] - 1 + ii * e.distance   # t_src <= bound
                if t[e.src] > bound:
                    nt = bound - ((bound - labels[e.src]) % ii)
                    t[e.src] = nt
                    changed = True
        # sol is a solution of the same system, so the greatest fixpoint is
        # pointwise >= sol and in particular within every window
        return TimeSolution(ii, t)

    def next_solution(
        self,
        *,
        deadline: float | None = None,
        step_budget: int | None = None,
    ) -> TimeSolution | None:
        start = _time.perf_counter()
        span = obs.span("time.probe", ii=self.ii, backend=self.stats.backend)
        steps0 = getattr(self._engine, "steps_total", 0)
        with span:
            try:
                t_abs = self._engine.next_solution(
                    deadline=deadline, step_budget=step_budget
                )
                if t_abs is None:
                    span.set(found=False,
                             exhausted=self._engine.exhausted,
                             steps=getattr(self._engine, "steps_total", 0) - steps0)
                    return None
                self.stats.num_solutions_enumerated += 1
                span.set(found=True,
                         steps=getattr(self._engine, "steps_total", 0) - steps0)
                return TimeSolution(self.ii, list(t_abs))
            finally:
                self.stats.solver_time_s += _time.perf_counter() - start
                self.stats.steps = getattr(self._engine, "steps_total", 0)


def check_time_solution(
    dfg: DFG, cgra: CGRA, sol: TimeSolution, *, connectivity: str = "paper"
) -> list[str]:
    """Independent validator; returns a list of violated-constraint messages."""
    errs: list[str] = []
    ii = sol.ii
    labels = sol.labels
    for e in dfg.edges:
        if not sol.t_abs[e.dst] >= sol.t_abs[e.src] + 1 - ii * e.distance:
            errs.append(f"dep {e} violated: t={sol.t_abs[e.src]},{sol.t_abs[e.dst]}")
    for i in range(ii):
        c = sum(1 for v in dfg.nodes if labels[v] == i)
        if c > cgra.num_pes:
            errs.append(f"capacity exceeded at step {i}: {c} > {cgra.num_pes}")
    if cgra.heterogeneous:
        from .cgra import op_class

        for cls in {op_class(dfg.ops[v]) for v in dfg.nodes}:
            cap = cgra.class_capacity(cls)
            if cap >= cgra.num_pes:
                continue
            for i in range(ii):
                c = sum(
                    1 for v in dfg.nodes
                    if labels[v] == i and op_class(dfg.ops[v]) == cls
                )
                if c > cap:
                    errs.append(
                        f"class capacity exceeded at step {i}: "
                        f"{c} {cls!r} ops > {cap}"
                    )
    d_m = cgra.connectivity_degree
    adj = dfg.undirected_adjacency()
    for v in dfg.nodes:
        for i in range(ii):
            cnt = sum(1 for u in adj[v] if labels[u] == i)
            limit = d_m
            if connectivity == "strict" and i == labels[v]:
                limit = d_m - 1
            if cnt > limit:
                errs.append(f"connectivity exceeded: node {v} step {i}: {cnt} > {limit}")
    return errs
