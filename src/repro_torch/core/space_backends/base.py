"""Space-backend protocol, shared datatypes and registry (DESIGN.md §13).

The space phase — embed a time-labelled DFG into the MRRG — is pluggable,
mirroring the time phase's ``time_backends`` registry: a backend is anything
with a ``place`` method turning one label partition into a
:class:`SpaceSolution` (or None within its budget). Two engines register
here:

* ``exact`` (space_backends/exact.py) — the paper's bitset monomorphism
  search, complete up to its node budget; the quality anchor.
* ``anneal`` (space_backends/anneal.py) — clustered placement + simulated
  annealing for very large fabrics (50×50 and beyond), where the exact
  engine's word width makes each visited node expensive.

This module also hosts what every backend shares: the solution/stats
datatypes, the placement validators (``check_monomorphism``/
``check_routes``), and the route-repair machinery (``_RouteContext``) that
materialises non-direct edges as ``mov`` chains (DESIGN.md §12.1) — the
legalization pass both engines hand off to.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Protocol

from ... import obs
from ..cgra import CGRA, op_class
from ..dfg import DFG
from ..time_backends.base import mov_slot_headroom

#: ``"auto"`` resolution threshold: fabrics with at most this many PEs use
#: the exact engine (complete, bit-identical to the paper's search); larger
#: homogeneous meshes use the window engine (the exact engine on a centred
#: sub-mesh of at most this many PEs, then anneal), other larger fabrics the
#: annealing backend, whose per-move cost does not grow with the bitmask
#: word width. 400 = the 20×20 grid of the paper's Fig. 5 sweep.
AUTO_EXACT_MAX_PES = 400


@dataclass(frozen=True)
class MaterializedRoute:
    """One realised route-through: the original edge, the intermediate PEs,
    and the absolute firing times of the movs that will occupy them."""

    edge: tuple[int, int, int]     # (src, dst, distance) of the routed edge
    path: tuple[int, ...]          # intermediate PEs, src side first
    times: tuple[int, ...]         # absolute mov times, strictly increasing


@dataclass
class SpaceSolution:
    ii: int
    placement: list[int]  # node -> PE index
    # route-throughs materialised by the repair loop; empty = direct embedding
    routes: tuple[MaterializedRoute, ...] = ()


@dataclass
class SpaceStats:
    search_time_s: float = 0.0
    nodes_visited: int = 0         # backtracking nodes / annealing moves
    backtracks: int = 0
    restarts: int = 0
    route_failures: int = 0        # complete placements whose movs didn't fit
    deadline_stops: int = 0        # dives (or restarts) cut by the wall clock
    budget_stops: int = 0          # dives stopped by their node/move budget
    # where the window engine's placement came from: "window" (the exact
    # engine on the centred sub-mesh) or "fabric"; "" from the other engines
    region: str = ""

    def outcome(self, found: bool, cancelled: bool = False) -> str:
        """How a probe that these stats count ended, by precedence:
        ``found``, ``cancelled`` (the caller's ``should_stop``), ``timeout``
        (a dive hit its deadline), ``node_budget`` (a dive hit its budget),
        else ``exhausted`` (every dive ran its tree out). The anneal engine
        reads ``exhausted`` only where it refuses a partition outright (a
        node with no capable free slot); each restart it runs ends at its
        deadline, its move budget or its routing attempts."""
        if found:
            return "found"
        if cancelled:
            return "cancelled"
        if self.deadline_stops:
            return "timeout"
        if self.budget_stops:
            return "node_budget"
        return "exhausted"


@dataclass(frozen=True)
class SpaceBudget:
    """How much work one ``place`` call may spend.

    ``timeout_s=None`` with a ``node_budget`` is the deterministic contract:
    identical inputs take the identical search path regardless of load.
    """

    timeout_s: float | None = 4.0
    node_budget: int | None = None
    restarts: int = 6


class SpaceBackend(Protocol):  # pragma: no cover - typing only
    name: str

    def place(
        self,
        dfg: DFG,
        cgra: CGRA,
        labels: list[int],
        ii: int,
        *,
        t_abs: list[int] | None = None,
        max_route_hops: int = 0,
        budget: SpaceBudget | None = None,
        seed: int = 0,
        stats: SpaceStats | None = None,
        should_stop: Callable[[], bool] | None = None,
    ) -> SpaceSolution | None: ...


@dataclass
class _BackendSpec:
    name: str
    factory: Callable[[], "SpaceBackend"]
    aliases: tuple[str, ...] = ()


_REGISTRY: dict[str, _BackendSpec] = {}
_ALIASES: dict[str, str] = {}


def register_space_backend(
    name: str,
    factory: Callable[[], "SpaceBackend"],
    *,
    aliases: tuple[str, ...] = (),
) -> None:
    spec = _BackendSpec(name, factory, aliases)
    _REGISTRY[name] = spec
    for a in aliases:
        _ALIASES[a] = name


def resolve_space_backend_name(name: str, cgra: CGRA | None = None) -> str:
    """Canonicalise an alias/auto request to a concrete registered backend.

    ``"auto"`` needs the target fabric: exact up to
    :data:`AUTO_EXACT_MAX_PES` PEs; above, the window engine on a
    homogeneous mesh and anneal elsewhere (DESIGN.md §13.3).
    """
    if name == "auto":
        if cgra is None:
            raise ValueError(
                "resolving the 'auto' space backend needs the target CGRA"
            )
        if cgra.num_pes <= AUTO_EXACT_MAX_PES:
            return "exact"
        from .window import has_window   # window.py imports this module
        return "window" if has_window(cgra) else "anneal"
    name = _ALIASES.get(name, name)
    if name not in _REGISTRY:
        raise ValueError(f"unknown space backend {name!r}")
    return name


def available_space_backends() -> dict[str, bool]:
    """Backend name -> available (space backends are dependency-free, so
    every registered engine is importable; the dict shape mirrors
    ``time_backends.available_backends`` for diagnostics symmetry)."""
    return {n: True for n in _REGISTRY}


def create_space_backend(name: str, cgra: CGRA | None = None) -> "SpaceBackend":
    name = resolve_space_backend_name(name, cgra)
    return _REGISTRY[name].factory()


def resolve_space_backend(backend, cgra: CGRA | None = None) -> "SpaceBackend":
    """Name-or-instance resolution: a string goes through the registry
    (``"auto"`` needs ``cgra``), anything exposing ``place`` passes through
    — the hook custom placement strategies use without registering."""
    if isinstance(backend, str):
        return create_space_backend(backend, cgra)
    if hasattr(backend, "place"):
        return backend
    raise TypeError(
        f"space backend must be a name or an object with place(), "
        f"got {type(backend).__name__}"
    )


class _RouteContext:
    """Per-search route-through state (DESIGN.md §12.1).

    Precomputes, from the time solution, how far apart each adjacent node
    pair may be placed: an edge with absolute-time gap ``g`` (``t_dst -
    t_src + II*distance``) can absorb at most ``g - 1`` movs, each of which
    needs a strictly intermediate firing time, so the pair's placement may
    sit at closed-reach distance ``min(1 + max_hops, g)``. The search relaxes
    its candidate masks accordingly; :meth:`materialize` then realises every
    non-direct edge as a concrete mov chain over free (PE, step) slots — or
    fails, sending the search back to try another placement (the repair
    loop).
    """

    def __init__(
        self,
        dfg: DFG,
        cgra: CGRA,
        labels: list[int],
        t_abs: list[int],
        ii: int,
        max_hops: int,
    ) -> None:
        if t_abs is None:
            raise ValueError("route-through search needs the absolute schedule")
        self.dfg = dfg
        self.cgra = cgra
        self.labels = labels
        self.t_abs = t_abs
        self.ii = ii
        self.max_hops = max_hops
        self.closed = cgra.closed_masks
        self.alu_mask = cgra.capability_masks["alu"]
        # reach tables for every allowed hop level, 1-indexed by hop count
        self.reach = [None] + [
            cgra.reach_masks(h) for h in range(1, max_hops + 2)
        ]
        # per adjacent pair, the allowed placement reach (min over the
        # directed edges between the pair: every edge must be realisable)
        allow: dict[tuple[int, int], int] = {}
        for e in dfg.edges:
            if e.src == e.dst:
                continue
            gap = t_abs[e.dst] - t_abs[e.src] + ii * e.distance
            h = max(1, min(1 + max_hops, gap))
            key = (e.src, e.dst) if e.src < e.dst else (e.dst, e.src)
            allow[key] = min(allow.get(key, h), h)
        self.pair_allow = allow
        # widest allowance per node (conservative forward-checking mask)
        node_allow = [1] * dfg.num_nodes
        for (u, v), h in allow.items():
            node_allow[u] = max(node_allow[u], h)
            node_allow[v] = max(node_allow[v], h)
        self.node_allow = node_allow

    def pair_masks(self, u: int, v: int):
        """Reach-mask table governing where ``u`` may sit relative to ``v``."""
        key = (u, v) if u < v else (v, u)
        return self.reach[self.pair_allow[key]]

    # ------------------------------------------------------- materialization
    def materialize(
        self, placement: list[int], occ: list[int]
    ) -> list[MaterializedRoute] | None:
        """Realise every non-direct edge as a mov chain, or return None.

        Deterministic greedy-with-path-backtracking per edge (edges in DFG
        order, paths in ascending-PE order, times earliest-first); movs claim
        (PE, step) slots against both the placed nodes (``occ``) and each
        other. The shared slot accounting (time_backends.base.
        ``mov_slot_headroom``) fast-fails steps with no capacity left.
        """
        closed, ii = self.closed, self.ii
        num_pes = self.cgra.num_pes
        headroom = mov_slot_headroom(self.labels, ii, num_pes)
        extra = [0] * ii                      # mov occupancy per kernel step
        routes: list[MaterializedRoute] = []
        for e in self.dfg.edges:
            if e.src == e.dst:
                continue
            p_src, p_dst = placement[e.src], placement[e.dst]
            if (closed[p_src] >> p_dst) & 1:
                continue                      # direct edge, no movs
            gap = self.t_abs[e.dst] - self.t_abs[e.src] + ii * e.distance
            route = self._route_edge(e, p_src, p_dst, gap, occ, extra, headroom)
            if route is None:
                obs.event("space.route", ok=False, ii=ii,
                          edge=f"{e.src}->{e.dst}", routed=len(routes))
                return None
            for pe, t in zip(route.path, route.times):
                extra[t % ii] |= 1 << pe
                headroom[t % ii] -= 1
            routes.append(route)
        if routes:
            obs.event("space.route", ok=True, ii=ii, routed=len(routes),
                      movs=sum(len(r.path) for r in routes))
        return routes

    def _route_edge(
        self, e, p_src: int, p_dst: int, gap: int,
        occ: list[int], extra: list[int], headroom: list[int],
    ) -> MaterializedRoute | None:
        ii = self.ii
        t_lo = self.t_abs[e.src]              # movs fire strictly after this
        t_hi = t_lo + gap                     # ... and strictly before this
        max_movs = min(self.max_hops, gap - 1)
        closed, alu = self.closed, self.alu_mask

        def assign_times(path: tuple[int, ...]) -> tuple[int, ...] | None:
            k = len(path)
            ts: list[int] = []
            t_prev = t_lo
            for j, pe in enumerate(path):
                t = t_prev + 1
                limit = t_hi - (k - j)        # leave room for the tail movs
                while t <= limit and ((occ[t % ii] | extra[t % ii]) >> pe) & 1:
                    t += 1
                if t > limit:
                    return None
                ts.append(t)
                t_prev = t
            return tuple(ts)

        budget = 256                          # path attempts per edge
        free_total = sum(h for h in headroom if h > 0)
        for k in range(1, max_movs + 1):
            # a chain of k movs needs k free slots (steps may host several)
            if free_total < k:
                return None
            # DFS over intermediate PEs: step j must stay within closed reach
            # of its predecessor and within (k - j) hops of the destination
            stack: list[tuple[int, tuple[int, ...]]] = [(p_src, ())]
            while stack and budget > 0:
                prev, path = stack.pop()
                j = len(path)
                if j == k:
                    budget -= 1
                    ts = assign_times(path)
                    if ts is not None:
                        return MaterializedRoute(
                            edge=(e.src, e.dst, e.distance),
                            path=path, times=ts,
                        )
                    continue
                cand = closed[prev] & alu & self.reach[k - j][p_dst]
                pes: list[int] = []
                while cand:
                    b = cand & -cand
                    pes.append(b.bit_length() - 1)
                    cand ^= b
                # LIFO stack: push descending so lowest PE is explored first
                for pe in reversed(pes):
                    stack.append((pe, path + (pe,)))
        return None


def check_routes(
    dfg: DFG, cgra: CGRA, t_abs: list[int], placement: list[int],
    ii: int, routes,
) -> list[str]:
    """Independent validator of route-through provenance (DESIGN.md §12.2).

    ``dfg`` is the *rewritten* DFG and ``routes`` its ``dfg.Route`` records.
    Every structural property (slot exclusivity, chain adjacency, dependency
    ordering) is already covered by ``check_monomorphism``/
    ``check_time_solution`` on the rewritten graph; this re-checks the
    route-specific contract — movs really are movs, chains connect their
    endpoints through closed-adjacent PEs, and firing times sit strictly
    inside the routed edge's time window.
    """
    errs: list[str] = []
    for r in routes:
        chain = (r.src, *r.movs, r.dst)
        for m in r.movs:
            if not 0 <= m < dfg.num_nodes or dfg.ops[m] != "mov":
                errs.append(f"route {r.src}->{r.dst}: node {m} is not a mov")
        for a, b in zip(chain, chain[1:]):
            if not cgra.adjacency[placement[a]][placement[b]]:
                errs.append(
                    f"route {r.src}->{r.dst}: hop {a}->{b} maps to "
                    f"non-adjacent PEs {placement[a]},{placement[b]}"
                )
        lo, hi = t_abs[r.src], t_abs[r.dst] + ii * r.distance
        times = [t_abs[m] for m in r.movs]
        if not all(x < y for x, y in zip([lo, *times], [*times, hi])):
            errs.append(
                f"route {r.src}->{r.dst}: mov times {times} not strictly "
                f"inside ({lo}, {hi})"
            )
    return errs


def check_monomorphism(
    dfg: DFG, cgra: CGRA, labels: list[int], placement: list[int], ii: int
) -> list[str]:
    """Independent validator of mono1/mono2/mono3; returns violations."""
    errs: list[str] = []
    seen: dict[tuple[int, int], int] = {}
    for v in dfg.nodes:
        key = (placement[v], labels[v])
        if key in seen:
            errs.append(f"mono1: nodes {seen[key]} and {v} share MRRG vertex {key}")
        seen[key] = v
        if not 0 <= placement[v] < cgra.num_pes:
            errs.append(f"node {v} placed out of range: {placement[v]}")
            continue
        if cgra.heterogeneous:
            cls = op_class(dfg.ops[v])
            if not cgra.capable(placement[v], cls):
                errs.append(
                    f"capability: node {v} ({dfg.ops[v]}, class {cls!r}) "
                    f"placed on incapable PE {placement[v]}"
                )
    adj = dfg.undirected_adjacency()
    for v in dfg.nodes:
        for u in adj[v]:
            if u < v:
                continue
            if not cgra.adjacency[placement[u]][placement[v]]:
                errs.append(
                    f"mono3: edge {{{u},{v}}} maps to non-adjacent PEs "
                    f"{placement[u]},{placement[v]}"
                )
    return errs
