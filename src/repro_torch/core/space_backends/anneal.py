"""Annealing space backend: clustered placement for very large fabrics.

The exact engine (space_backends/exact.py) pays for its completeness in word
width: every candidate intersection is an ``num_pes``-bit AND, so a 100×100
fabric makes each visited node ~60× more expensive than at 4×4 while the
search tree keeps its depth. This backend trades completeness for per-move
cost that is independent of fabric size, the classic two-phase
cluster-then-anneal placement shape (DESIGN.md §13.2):

1. **Cluster** the time-partitioned DFG: k-means-style grouping over
   undirected DFG hop distance (farthest-point seeding, multi-source BFS
   assignment, one medoid refinement), so tightly coupled nodes travel
   together.
2. **Seed** cluster centroids on a coarse tile grid over the fabric, then
   place each node greedily on the nearest free capable (PE, step) slot to
   its cluster centre (nudged toward already-placed neighbours).
3. **Anneal**: simulated annealing at fixed time labels, min-conflicts
   flavoured — most moves pick a *violated* edge and drop one endpoint into
   the other's allowance neighbourhood (swapping with any occupant), with a
   small exploration share of blind relocates/swaps. The energy is
   topology-exact grid distance — Manhattan (mesh), wrapped Manhattan
   (torus), Chebyshev (diagonal), ``ceil(|dr|/2) + ceil(|dc|/2)``
   (one-hop) — which equals true closed-adjacency hop distance on every
   supported topology, so "every edge within its allowance" is exactly the
   monomorphism condition without any bitset work.
4. **Legalise/deblock**: when route-through is enabled, a zero-violation
   placement still has to realise its long edges as ``mov`` chains; the
   shared repair machinery (``_RouteContext.materialize``) does that, and a
   failure kicks a few nodes loose and resumes annealing (deblocking)
   instead of restarting cold.

Determinism contract matches the exact engine: ``timeout_s=None`` plus a
``node_budget`` (interpreted as total SA moves) makes the search a pure
function of its inputs and seed.
"""

from __future__ import annotations

import math
import random
import time as _time
from collections import deque

from ... import obs
from ..cgra import CGRA, op_class
from ..dfg import DFG
from .base import (
    SpaceBudget,
    SpaceSolution,
    SpaceStats,
    _RouteContext,
    check_monomorphism,
    register_space_backend,
)

# default SA moves per restart when the caller sets neither budget knob
_DEFAULT_MOVES = 20_000
# materialization attempts per restart before giving up on this start
_MAX_ROUTE_ATTEMPTS = 25
# share of moves that repair a violated edge (rest explore blindly)
_REPAIR_PROB = 0.85


def _grid_dist(topology: str, rows: int, cols: int):
    """Topology-exact hop distance between PEs, O(1) per query."""
    if topology == "mesh":
        def d(ar, ac, br, bc):
            return abs(ar - br) + abs(ac - bc)
    elif topology == "torus":
        def d(ar, ac, br, bc):
            dr, dc = abs(ar - br), abs(ac - bc)
            return min(dr, rows - dr) + min(dc, cols - dc)
    elif topology == "diagonal":
        def d(ar, ac, br, bc):
            return max(abs(ar - br), abs(ac - bc))
    else:  # one-hop: cardinal strides of 1 and 2
        def d(ar, ac, br, bc):
            return (abs(ar - br) + 1) // 2 + (abs(ac - bc) + 1) // 2
    return d


def _cluster(dfg: DFG) -> tuple[list[int], int]:
    """k-means-style clustering over DFG hop distance.

    Returns (cluster id per node, k). Fully deterministic: farthest-point
    seeding from the highest-degree node, nearest-seed assignment (ties to
    the lower cluster id), one medoid-refinement pass.
    """
    n = dfg.num_nodes
    adj = dfg.undirected_adjacency()
    k = max(1, min(n, round(math.sqrt(n))))

    def bfs(src: int) -> list[int]:
        dist = [-1] * n
        dist[src] = 0
        q = deque([src])
        while q:
            v = q.popleft()
            for u in adj[v]:
                if dist[u] < 0:
                    dist[u] = dist[v] + 1
                    q.append(u)
        return dist

    degs = [len(adj[v]) for v in range(n)]
    seeds = [max(range(n), key=lambda v: (degs[v], -v))]
    seed_dist = [bfs(seeds[0])]
    far = n + 1                      # unreachable sorts farthest: spread
    while len(seeds) < k:            # across DFG components first
        def spread(v: int) -> int:
            return min(far if d[v] < 0 else d[v] for d in seed_dist)
        v = max(
            (v for v in range(n) if v not in seeds),
            key=lambda v: (spread(v), degs[v], -v),
        )
        seeds.append(v)
        seed_dist.append(bfs(v))

    def assign() -> list[int]:
        return [
            min(
                range(len(seeds)),
                key=lambda i: (far if seed_dist[i][v] < 0 else seed_dist[i][v], i),
            )
            for v in range(n)
        ]

    clusters = assign()
    # one medoid refinement: re-centre each cluster on its min-eccentricity
    # member, then re-assign
    for i in range(len(seeds)):
        members = [v for v in range(n) if clusters[v] == i]
        if not members:
            continue
        best, best_ecc = seeds[i], None
        for v in members:
            d = bfs(v)
            ecc = max(far if d[u] < 0 else d[u] for u in members)
            if best_ecc is None or (ecc, v) < (best_ecc, best):
                best, best_ecc = v, ecc
        if best != seeds[i]:
            seeds[i] = best
            seed_dist[i] = bfs(best)
    return assign(), len(seeds)


class AnnealSpaceBackend:
    """Clustered placement + simulated annealing (DESIGN.md §13.2)."""

    name = "anneal"

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
        stats = stats if stats is not None else SpaceStats()
        n = dfg.num_nodes
        num_pes = cgra.num_pes
        rows, cols = cgra.rows, cgra.cols
        if n > num_pes * ii:
            return None
        for v in range(n):
            if not 0 <= labels[v] < ii:
                raise ValueError(f"label out of range for node {v}: {labels[v]}")

        full = (1 << num_pes) - 1
        if cgra.heterogeneous:
            cap_masks = cgra.capability_masks
            node_mask = [cap_masks[op_class(dfg.ops[v])] for v in range(n)]
            if not all(node_mask):
                return None
        else:
            node_mask = [full] * n

        route_ctx = (
            _RouteContext(dfg, cgra, labels, t_abs, ii, max_route_hops)
            if max_route_hops > 0 else None
        )
        dist_rc = _grid_dist(cgra.topology, rows, cols)

        def dist_pe(pu: int, pv: int) -> int:
            return dist_rc(pu // cols, pu % cols, pv // cols, pv % cols)

        # undirected pair list with per-pair hop allowance; incident index
        pair_allow: dict[tuple[int, int], int] = {}
        for e in dfg.edges:
            if e.src == e.dst:
                continue
            key = (e.src, e.dst) if e.src < e.dst else (e.dst, e.src)
            a = route_ctx.pair_allow[key] if route_ctx is not None else 1
            pair_allow[key] = a
        pairs = sorted(pair_allow.items())    # deterministic iteration order
        inc: list[list[tuple[int, int]]] = [[] for _ in range(n)]
        for (u, v), a in pairs:
            inc[u].append((v, a))
            inc[v].append((u, a))

        def edge_cost(pu: int, pv: int, allow: int) -> tuple[int, float]:
            d = dist_pe(pu, pv)
            over = d - allow
            if over > 0:
                return over, over * over + 0.01 * d
            return 0, 0.01 * d

        # allowance-neighbourhood offsets, cached per allowance level: the
        # cells a repair move may drop an endpoint into
        _nbhd_cache: dict[int, tuple[tuple[int, int], ...]] = {}

        def nbhd_offsets(a: int) -> tuple[tuple[int, int], ...]:
            offs = _nbhd_cache.get(a)
            if offs is None:
                s = 2 * a if cgra.topology == "one-hop" else a
                offs = tuple(
                    (dr, dc)
                    for dr in range(-s, s + 1)
                    for dc in range(-s, s + 1)
                    if dist_rc(0, 0, abs(dr), abs(dc)) <= a
                )
                _nbhd_cache[a] = offs
            return offs

        def nbhd_cells(pe: int, a: int) -> list[int]:
            pr, pc = pe // cols, pe % cols
            out: list[int] = []
            for dr, dc in nbhd_offsets(a):
                nr, nc = pr + dr, pc + dc
                if cgra.topology == "torus":
                    nr %= rows
                    nc %= cols
                elif not (0 <= nr < rows and 0 <= nc < cols):
                    continue
                out.append(nr * cols + nc)
            return out

        _ring_cache: dict[int, tuple[tuple[int, int], ...]] = {}

        def nearest_free(target_pe: int, free: int) -> int:
            """First free-capable PE by expanding metric rings from target.

            O(cells inspected) instead of a full ``num_pes``-bit mask scan —
            the near-empty huge-fabric case finds a slot within a few rings.
            """
            tr, tc = target_pe // cols, target_pe % cols
            for a in range(diam + 1):
                ring = _ring_cache.get(a)
                if ring is None:
                    s = 2 * a if cgra.topology == "one-hop" else a
                    ring = tuple(
                        (dr, dc)
                        for dr in range(-s, s + 1)
                        for dc in range(-s, s + 1)
                        if dist_rc(0, 0, abs(dr), abs(dc)) == a
                    )
                    _ring_cache[a] = ring
                for dr, dc in ring:
                    nr, nc = tr + dr, tc + dc
                    if cgra.topology == "torus":
                        nr %= rows
                        nc %= cols
                    elif not (0 <= nr < rows and 0 <= nc < cols):
                        continue
                    pe = nr * cols + nc
                    if (free >> pe) & 1:
                        return pe
            return -1

        start = _time.perf_counter()
        wall = b.timeout_s if b.timeout_s is not None else float("inf")
        n_restarts = max(1, b.restarts)
        weights = [1] + [1 << min(r, 30) for r in range(n_restarts - 1)]
        total_w = sum(weights)

        clusters, k = _cluster(dfg)
        # coarse tile grid for the k cluster centroids, packed into a compact
        # window at the fabric centre: a legal embedding only ever spans a
        # few cells per time step (every edge must close to within its hop
        # allowance), so on a huge fabric the extra area is pure noise —
        # seeding compactly makes 100×100 behave like 20×20
        g = max(1, math.ceil(math.sqrt(k)))
        span_r = min(rows, max(2 * g, math.ceil(math.sqrt(n)) + g))
        span_c = min(cols, max(2 * g, math.ceil(math.sqrt(n)) + g))
        off_r, off_c = (rows - span_r) / 2, (cols - span_c) / 2
        centroid = [
            (off_r + (i // g + 0.5) * span_r / g,
             off_c + (i % g + 0.5) * span_c / g)
            for i in range(k)
        ]

        # deterministic init order: clusters in id order, BFS inside each
        adj = dfg.undirected_adjacency()
        order: list[int] = []
        seen = [False] * n
        for ci in range(k):
            for s in sorted(v for v in range(n) if clusters[v] == ci):
                if seen[s]:
                    continue
                seen[s] = True
                q = deque([s])
                while q:
                    v = q.popleft()
                    order.append(v)
                    for u in sorted(adj[v]):
                        if not seen[u] and clusters[u] == ci:
                            seen[u] = True
                            q.append(u)

        diam = dist_rc(0, 0, rows - 1, cols - 1) or 1

        for r in range(n_restarts):
            remaining = wall - (_time.perf_counter() - start)
            if remaining <= 0:
                stats.deadline_stops += 1
                break
            if should_stop is not None and should_stop():
                break
            stats.restarts += 1
            rng = random.Random(seed * 7919 + r)
            frac = weights[r] / total_w
            deadline = (
                _time.perf_counter() + min(wall * frac, remaining)
                if wall != float("inf") else None
            )
            if b.node_budget is not None:
                moves_budget = max(500, int(b.node_budget * frac))
            else:
                moves_budget = _DEFAULT_MOVES

            # ---------------- initial placement: nearest free capable slot
            placement = [-1] * n
            occ = [0] * ii
            owner: list[dict[int, int]] = [dict() for _ in range(ii)]
            failed = False
            for v in order:
                tr, tc = centroid[clusters[v]]
                placed_nb = [placement[u] for u, _ in inc[v] if placement[u] >= 0]
                if placed_nb:
                    tr = sum(p // cols for p in placed_nb) / len(placed_nb)
                    tc = sum(p % cols for p in placed_nb) / len(placed_nb)
                if r > 0:                 # restart diversity: jitter targets
                    tr += rng.uniform(-span_r / 4, span_r / 4)
                    tc += rng.uniform(-span_c / 4, span_c / 4)
                tri = min(rows - 1, max(0, round(tr)))
                tci = min(cols - 1, max(0, round(tc)))
                best = nearest_free(
                    tri * cols + tci, node_mask[v] & ~occ[labels[v]]
                )
                if best < 0:
                    failed = True         # no capable free slot at this step
                    break
                placement[v] = best
                occ[labels[v]] |= 1 << best
                owner[labels[v]][best] = v
            if failed:
                return None               # capacity infeasible, rng-independent

            viol = 0
            energy = 0.0
            bad: set[tuple[int, int]] = set()
            for (u, v), a in pairs:
                o, c = edge_cost(placement[u], placement[v], a)
                viol += o
                energy += c
                if o:
                    bad.add((u, v))

            def node_cost(v: int) -> tuple[int, float]:
                o_sum, c_sum = 0, 0.0
                pv = placement[v]
                for u, a in inc[v]:
                    o, c = edge_cost(pv, placement[u], a)
                    o_sum += o
                    c_sum += c
                return o_sum, c_sum

            def refresh_bad(v: int) -> None:
                for u, a in inc[v]:
                    key = (u, v) if u < v else (v, u)
                    if edge_cost(placement[u], placement[v], a)[0]:
                        bad.add(key)
                    else:
                        bad.discard(key)

            def move_to(v: int, pe: int) -> None:
                lv = labels[v]
                old = placement[v]
                occ[lv] = (occ[lv] & ~(1 << old)) | (1 << pe)
                del owner[lv][old]
                owner[lv][pe] = v
                placement[v] = pe

            def try_finish() -> SpaceSolution | None:
                """viol==0: certify (and, under routing, materialise)."""
                if route_ctx is None:
                    if check_monomorphism(dfg, cgra, labels, placement, ii):
                        return None       # metric/validator disagree: reject
                    return SpaceSolution(ii=ii, placement=list(placement))
                routes = route_ctx.materialize(placement, occ)
                if routes is None:
                    stats.route_failures += 1
                    return None
                return SpaceSolution(
                    ii=ii, placement=list(placement), routes=tuple(routes)
                )

            def rand_near(pe: int) -> int:
                """Random PE within the embedding-scale window around ``pe``."""
                nr = pe // cols + rng.randint(-span_r, span_r)
                nc = pe % cols + rng.randint(-span_c, span_c)
                if cgra.topology == "torus":
                    return nr % rows * cols + nc % cols
                nr = min(rows - 1, max(0, nr))
                nc = min(cols - 1, max(0, nc))
                return nr * cols + nc

            route_attempts = 0
            # energy-curve telemetry (DESIGN.md §15, ROADMAP "anneal quality
            # tuning"): purely observational — counters and obs events only,
            # never an rng draw, so traced and untraced runs take the
            # identical search path
            traced = obs.enabled()
            accepts = proposals = 0

            def emit_restart(found: bool) -> None:
                # per-restart energy-curve summary: how the restart ended
                # (energy/violations left, realised accept rate) — the data
                # the anneal-quality tuning reads back out of traces
                if traced:
                    obs.event(
                        "space.anneal.restart", ii=ii, restart=r, found=found,
                        energy=round(energy, 3), viol=viol,
                        accepts=accepts, proposals=proposals,
                        accept_rate=(round(accepts / proposals, 4)
                                     if proposals else None),
                        route_attempts=route_attempts,
                    )

            if viol == 0:
                sol = try_finish()
                if sol is not None:
                    emit_restart(found=True)
                    stats.search_time_s += _time.perf_counter() - start
                    return sol
                route_attempts += 1

            # ---------------- min-conflicts simulated annealing
            by_label: dict[int, list[int]] = {}
            for v in range(n):
                by_label.setdefault(labels[v], []).append(v)
            t0 = 2.0
            t_min = 0.02
            alpha = (t_min / t0) ** (1.0 / max(1, moves_budget))
            temp = t0
            aborted = False
            for step in range(moves_budget):
                temp *= alpha
                if not step & 0xFF:
                    if should_stop is not None and should_stop():
                        aborted = True
                        break
                    if deadline is not None and _time.perf_counter() > deadline:
                        stats.deadline_stops += 1
                        break
                    if traced and not step & 0xFFF:
                        obs.event(
                            "space.anneal.sample", ii=ii, restart=r,
                            step=step, energy=round(energy, 3), viol=viol,
                            temperature=round(temp, 5),
                            accept_rate=(round(accepts / proposals, 4)
                                         if proposals else None),
                        )
                stats.nodes_visited += 1

                # -------- propose: repair a violated edge, or explore
                x = w = -1                # mover and (optional) swap partner
                target = -1
                if bad and rng.random() < _REPAIR_PROB:
                    key = sorted(bad)[rng.randrange(len(bad))]
                    x, y = key if rng.random() < 0.5 else key[::-1]
                    cells = nbhd_cells(placement[y], pair_allow[key])
                    pe = cells[rng.randrange(len(cells))]
                    if pe == placement[x] or not (node_mask[x] >> pe) & 1:
                        continue
                    z = owner[labels[x]].get(pe, -1)
                    if z >= 0:
                        if not (node_mask[z] >> placement[x]) & 1:
                            continue
                        w = z
                    target = pe
                else:
                    x = rng.randrange(n)
                    lx = labels[x]
                    peers = by_label[lx]
                    if len(peers) > 1 and rng.random() < 0.5:
                        z = peers[rng.randrange(len(peers))]
                        if z == x:
                            continue
                        if not (
                            (node_mask[x] >> placement[z]) & 1
                            and (node_mask[z] >> placement[x]) & 1
                        ):
                            continue
                        w, target = z, placement[z]
                    else:
                        px = placement[x]
                        for _ in range(8):
                            nr = px // cols + rng.randint(-3, 3)
                            nc = px % cols + rng.randint(-3, 3)
                            if cgra.topology == "torus":
                                nr %= rows
                                nc %= cols
                            elif not (0 <= nr < rows and 0 <= nc < cols):
                                continue
                            pe = nr * cols + nc
                            if (node_mask[x] >> pe) & 1 and not (occ[lx] >> pe) & 1:
                                target = pe
                                break
                        if target < 0:
                            for _ in range(16):
                                pe = rand_near(px)
                                if (node_mask[x] >> pe) & 1 and not (occ[lx] >> pe) & 1:
                                    target = pe
                                    break
                        if target < 0:
                            continue

                # -------- evaluate delta (x moves to target; w takes x's slot)
                proposals += 1
                px = placement[x]
                if w >= 0:
                    o0, c0 = node_cost(x)[0] + node_cost(w)[0], node_cost(x)[1] + node_cost(w)[1]
                    placement[x], placement[w] = target, px
                    o1 = node_cost(x)[0] + node_cost(w)[0]
                    c1 = node_cost(x)[1] + node_cost(w)[1]
                    # x–w edges are counted from both sides in both states,
                    # so the doubled terms cancel in the delta
                    d_o, d_c = o1 - o0, c1 - c0
                    if d_c <= 0 or rng.random() < math.exp(-d_c / temp):
                        lx, lw = labels[x], labels[w]
                        owner[lx][target] = x
                        owner[lw][px] = w
                        viol += d_o
                        energy += d_c
                        refresh_bad(x)
                        refresh_bad(w)
                        accepts += 1
                    else:
                        placement[x], placement[w] = px, target
                        stats.backtracks += 1
                        continue
                else:
                    o0, c0 = node_cost(x)
                    placement[x] = target
                    o1, c1 = node_cost(x)
                    d_o, d_c = o1 - o0, c1 - c0
                    if d_c <= 0 or rng.random() < math.exp(-d_c / temp):
                        placement[x] = px
                        move_to(x, target)
                        viol += d_o
                        energy += d_c
                        refresh_bad(x)
                        accepts += 1
                    else:
                        placement[x] = px
                        stats.backtracks += 1
                        continue

                if viol == 0:
                    sol = try_finish()
                    if sol is not None:
                        emit_restart(found=True)
                        stats.search_time_s += _time.perf_counter() - start
                        return sol
                    route_attempts += 1
                    if route_attempts > _MAX_ROUTE_ATTEMPTS:
                        stats.budget_stops += 1   # out of routing attempts
                        break
                    # deblock: kick a few nodes loose and keep annealing warm
                    for _ in range(max(2, n // 10)):
                        v = rng.randrange(n)
                        lv = labels[v]
                        for _ in range(16):
                            pe = rand_near(placement[v])
                            if (node_mask[v] >> pe) & 1 and not (occ[lv] >> pe) & 1:
                                move_to(v, pe)
                                break
                    viol, energy = 0, 0.0
                    bad.clear()
                    for (u, v), a in pairs:
                        o, c = edge_cost(placement[u], placement[v], a)
                        viol += o
                        energy += c
                        if o:
                            bad.add((u, v))
                    temp = max(temp, t0 / 4)
            else:
                stats.budget_stops += 1   # the restart's moves ran out
            emit_restart(found=False)
            if aborted:
                break
        stats.search_time_s += _time.perf_counter() - start
        return None


register_space_backend("anneal", AnnealSpaceBackend, aliases=("sa", "cluster"))
