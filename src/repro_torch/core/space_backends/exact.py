"""Exact space backend: monomorphism bitset engine (paper §IV-C).

Given a time solution (kernel label per DFG node), find an injective,
label-preserving, edge-preserving embedding of the undirected DFG into the
MRRG. Under the register-file architecture (see core/cgra.py) an MRRG edge
exists between (pe_u, t_u) and (pe_v, t_v) iff pe_u equals-or-neighbours pe_v,
so the search reduces to placing each node on a PE such that

  * at each kernel step, every PE hosts at most one node   (mono1 + mono2)
  * G-adjacent nodes land on closed-adjacent PEs           (mono3)

The search is a VF2/RI-style backtracking specialised to the label structure:
connected expansion order (most-placed-neighbours first), candidate sets from
the intersection of placed neighbours' closed neighbourhoods, forward checking
(every placed node must retain enough free adjacent slots per step for its
unplaced neighbours), and randomised restarts — the classic recipe that gives
VF3-class robustness [29,30] while exploiting the time labels, which partition
the injectivity constraint by step and keep the search shallow.

All PE sets are int bitmasks (bit p = PE p; layout contract in DESIGN.md §5,
masks precomputed in ``CGRA.closed_masks``): candidate intersection is a chain
of ANDs maintained incrementally per node, occupancy per kernel step is one
word, and forward checking is popcount over ``closed & ~occ`` — O(words) per
check instead of O(|set|), which is what lets 20x20 grids (400-bit words)
search millions of candidates per second in pure Python.

Budgets: ``timeout_s`` (wall clock) and/or ``node_budget`` (deterministic
visited-node cap, used by tests and the mapper's deterministic mode).
"""

from __future__ import annotations

import random
import time as _time

from ... import obs
from ..cgra import CGRA, op_class
from ..dfg import DFG
from .base import (
    MaterializedRoute,
    SpaceBudget,
    SpaceSolution,
    SpaceStats,
    _RouteContext,
    register_space_backend,
)


def find_monomorphism(
    dfg: DFG,
    cgra: CGRA,
    labels: list[int],
    ii: int,
    *,
    timeout_s: float | None = 4.0,
    node_budget: int | None = None,
    restarts: int = 6,
    seed: int = 0,
    stats: SpaceStats | None = None,
    t_abs: list[int] | None = None,
    max_route_hops: int = 0,
) -> SpaceSolution | None:
    """Randomised-restart wrapper around one backtracking dive per seed.

    With ``timeout_s=None`` and a ``node_budget``, the search is fully
    deterministic: identical inputs always visit the identical tree prefix.

    ``max_route_hops > 0`` enables route-through repair (DESIGN.md §12):
    G-adjacent nodes may then land up to ``1 + max_route_hops`` closed-
    adjacency steps apart, and every non-direct edge of a complete placement
    is realised as a chain of ``mov`` nodes over free (PE, step) slots —
    returned in ``SpaceSolution.routes``. This needs the absolute schedule
    (``t_abs``): an edge's hop allowance is bounded by its time gap, and the
    movs' firing times are picked inside it. ``max_route_hops=0`` (default)
    is bit-identical to the historical direct-only search.
    """
    stats = stats if stats is not None else SpaceStats()
    route_ctx = (
        _RouteContext(dfg, cgra, labels, t_abs, ii, max_route_hops)
        if max_route_hops > 0 else None
    )
    start = _time.perf_counter()
    budget = timeout_s if timeout_s is not None else float("inf")
    n_restarts = max(1, restarts)
    # geometric restart schedule: cheap early probes, one deep final dive —
    # weights 1,1,2,4,...  (the last restart gets ~half the total budget)
    weights = [1] + [1 << min(r, 30) for r in range(n_restarts - 1)]
    total_w = sum(weights)
    traced = obs.enabled()
    for r in range(n_restarts):
        remaining = budget - (_time.perf_counter() - start)
        if remaining <= 0:
            break
        stats.restarts += 1
        frac = weights[r] / total_w
        n0, b0 = stats.nodes_visited, stats.backtracks
        sol = _search_once(
            dfg, cgra, labels, ii,
            deadline=(
                _time.perf_counter() + min(budget * frac, remaining)
                if budget != float("inf") else None
            ),
            node_budget=(
                max(1, int(node_budget * frac)) if node_budget is not None else None
            ),
            rng=random.Random(seed * 7919 + r),
            shuffle=r > 0,   # first dive is deterministic greedy
            stats=stats,
            route_ctx=route_ctx,
        )
        if traced:
            # restart-boundary telemetry only (DESIGN.md §15): the dive
            # itself stays untouched — the golden 4x4 pins its search path
            # bit-for-bit. prune_rate = backtracks per visited node; a high
            # rate means the candidate masks are paying for themselves.
            nodes = stats.nodes_visited - n0
            backtracks = stats.backtracks - b0
            obs.event(
                "space.exact.restart", ii=ii, restart=r, nodes=nodes,
                backtracks=backtracks, found=sol is not None,
                prune_rate=round(backtracks / nodes, 4) if nodes else None,
            )
        if sol is not None:
            placement, routes = sol
            stats.search_time_s += _time.perf_counter() - start
            return SpaceSolution(ii=ii, placement=placement, routes=routes)
    stats.search_time_s += _time.perf_counter() - start
    return None


def _search_once(
    dfg: DFG,
    cgra: CGRA,
    labels: list[int],
    ii: int,
    *,
    deadline: float | None,
    node_budget: int | None,
    rng: random.Random,
    shuffle: bool,
    stats: SpaceStats,
    route_ctx: _RouteContext | None = None,
) -> tuple[list[int], tuple[MaterializedRoute, ...]] | None:
    n = dfg.num_nodes
    adj_sets = dfg.undirected_adjacency()
    adj = [tuple(sorted(s)) for s in adj_sets]
    num_pes = cgra.num_pes
    closed = cgra.closed_masks
    full = (1 << num_pes) - 1

    if n > num_pes * ii:
        return None
    for v in range(n):
        if not 0 <= labels[v] < ii:
            raise ValueError(f"label out of range for node {v}: {labels[v]}")

    # Capability pruning (DESIGN.md §10): a node may only sit on a PE whose
    # class set covers its op — seed each candidate mask with the op-class
    # mask so incapable placements vanish at the bitset layer instead of
    # being discovered (and backtracked out of) by the search. Homogeneous
    # grids keep the full mask, leaving the search path bit-identical.
    if cgra.heterogeneous:
        cap_masks = cgra.capability_masks
        node_mask = [cap_masks[op_class(dfg.ops[v])] for v in range(n)]
        if not all(node_mask):
            return None            # some op has no capable PE at all
    else:
        node_mask = [full] * n

    degs = [len(adj[v]) for v in range(n)]
    # static value-order rank: interior PEs (largest closed nbhd) first keeps
    # future intersections large; jitter on restarts
    pe_rank = sorted(range(num_pes), key=lambda p: -closed[p].bit_count())
    if shuffle:
        rng.shuffle(pe_rank)
    rank_of = [0] * num_pes
    for i, p in enumerate(pe_rank):
        rank_of[p] = i

    placement = [-1] * n
    occ = [0] * ii                       # occupied-PE mask per kernel step
    # candidate mask per node: op-class mask AND placed neighbours' closed masks
    cand = list(node_mask)
    placed_nbrs = [0] * n
    # unplaced-neighbour demand per (node, step), updated incrementally
    need = [[0] * ii for _ in range(n)]
    for v in range(n):
        for u in adj[v]:
            need[v][labels[u]] += 1

    budget_left = node_budget if node_budget is not None else -1
    check_tick = 0

    # route-through relaxation: a placed node's reachable area for forward
    # checking, and the routes of the accepted placement (repair loop)
    if route_ctx is not None:
        node_reach = [
            route_ctx.reach[route_ctx.node_allow[v]] for v in range(n)
        ]
    found_routes: list[MaterializedRoute] = []

    def complete() -> bool:
        """Accept a full placement; under routing, movs must materialise."""
        if route_ctx is None:
            return True
        routes = route_ctx.materialize(placement, occ)
        if routes is None:
            stats.route_failures += 1
            return False
        found_routes[:] = routes
        return True

    def forward_ok(u: int) -> bool:
        """Placed node u must keep enough free adjacent slots per step."""
        if route_ctx is None:
            cu = closed[placement[u]]
        else:
            cu = node_reach[u][placement[u]]
        nu = need[u]
        for step in range(ii):
            want = nu[step]
            if want and (cu & ~occ[step]).bit_count() < want:
                return False
        return True

    def seed_candidates(v: int) -> list[int]:
        free = node_mask[v] & ~occ[labels[v]]
        return [p for p in pe_rank if (1 << p) & free]

    def cand_list(v: int) -> list[int]:
        m = cand[v] & ~occ[labels[v]]
        out = []
        while m:
            b = m & -m
            out.append(b.bit_length() - 1)
            m ^= b
        out.sort(key=rank_of.__getitem__)   # per-restart jitter lives in pe_rank
        return out

    def place(v: int, p: int) -> list[tuple[int, int]]:
        placement[v] = p
        occ[labels[v]] |= 1 << p
        cp = closed[p]
        undo: list[tuple[int, int]] = []
        lv = labels[v]
        for u in adj[v]:
            need[u][lv] -= 1
            if placement[u] < 0:
                old = cand[u]
                if route_ctx is None:
                    new = old & cp
                else:
                    # per-pair reach: how far u may sit from v is bounded by
                    # the routable hop allowance of their connecting edges
                    new = old & route_ctx.pair_masks(u, v)[p]
                if new != old:
                    undo.append((u, old))
                    cand[u] = new
            placed_nbrs[u] += 1
        return undo

    def unplace(v: int, p: int, undo: list[tuple[int, int]]) -> None:
        lv = labels[v]
        for u in adj[v]:
            need[u][lv] += 1
            placed_nbrs[u] -= 1
        for u, old in undo:
            cand[u] = old
        occ[labels[v]] &= ~(1 << p)
        placement[v] = -1

    def select_var() -> tuple[int, list[int]] | None:
        """Dynamic MRV: among frontier nodes (>=1 placed neighbour), pick the
        one with the fewest candidate PEs; empty frontier seeds a component."""
        best_v, best_c = -1, -1
        for v in range(n):
            if placement[v] >= 0 or not placed_nbrs[v]:
                continue
            c = (cand[v] & ~occ[labels[v]]).bit_count()
            if c == 0:
                return (v, [])          # dead end: fail fast
            if best_v < 0 or (c, -degs[v]) < (best_c, -degs[best_v]):
                best_v, best_c = v, c
                if c == 1:
                    break
        if best_v >= 0:
            return best_v, cand_list(best_v)
        # new component seed: highest-degree unplaced node
        seeds = [v for v in range(n) if placement[v] < 0]
        if not seeds:
            return None
        v = max(seeds, key=lambda u: (degs[u], rng.random() if shuffle else 0))
        return v, seed_candidates(v)

    def rec(placed_count: int) -> int:
        """1 = solved, 0 = subtree exhausted, -1 = budget/deadline abort."""
        nonlocal budget_left, check_tick
        if placed_count == n:
            return 1 if complete() else 0
        check_tick += 1
        if deadline is not None and not check_tick & 0xFF:
            if _time.perf_counter() > deadline:
                return -1
        sel = select_var()
        if sel is None:
            return 1 if complete() else 0
        v, cands = sel
        lv = labels[v]
        for p in cands:
            stats.nodes_visited += 1
            if budget_left >= 0:
                budget_left -= 1
                if budget_left < 0:
                    return -1
            undo = place(v, p)
            # arc check: every unplaced neighbour must retain a candidate
            ok = all(
                cand[u] & ~occ[labels[u]]
                for u in adj[v]
                if placement[u] < 0
            )
            if ok and forward_ok(v):
                ok = all(
                    forward_ok(u) for u in adj[v] if placement[u] >= 0
                )
            if ok:
                r = rec(placed_count + 1)
                if r:
                    if r > 0:
                        return 1
                    unplace(v, p, undo)
                    return -1
            stats.backtracks += 1
            unplace(v, p, undo)
        return 0

    if rec(0) > 0:
        return list(placement), tuple(found_routes)
    return None


class ExactSpaceBackend:
    """Registry adapter over :func:`find_monomorphism`.

    A thin forwarding shim, deliberately: the golden 4×4 suite pins the
    engine's search path bit-for-bit, so ``place`` must add nothing beyond
    unpacking the :class:`SpaceBudget`.
    """

    name = "exact"

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
        should_stop=None,
    ) -> SpaceSolution | None:
        b = budget if budget is not None else SpaceBudget()
        return find_monomorphism(
            dfg, cgra, labels, ii,
            timeout_s=b.timeout_s,
            node_budget=b.node_budget,
            restarts=b.restarts,
            seed=seed,
            stats=stats,
            t_abs=t_abs,
            max_route_hops=max_route_hops,
        )


register_space_backend("exact", ExactSpaceBackend, aliases=("mono", "bitset"))
