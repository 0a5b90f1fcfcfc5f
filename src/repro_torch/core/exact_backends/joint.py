"""Complete joint (kernel step, PE) search for one candidate II (§14.1).

The decoupled pipeline answers "does *this label partition* embed?"; this
module answers the question the portfolio can only approximate: "does *any*
mapping of the DFG onto ``MRRG(cgra, ii)`` exist?" — by branching jointly on
the pair (label ``t mod II``, PE) per node. That joint domain is exactly the
MRRG vertex set, so one search decides both phases at once:

* **slot exclusivity** — two nodes never share a (PE, label) slot (the MRRG
  vertex-injectivity of the monomorphism phase);
* **adjacency** — every DFG edge lands on closed-adjacent PEs
  (``CGRA.closed_masks``; ``reach_hops > 1`` relaxes to ``reach_masks`` for
  route-through lower bounds, DESIGN.md §14.3);
* **capability/ports** — a node only sits on a PE of its op class, and at
  most ``class_capacity("mem")`` memory ops share one kernel step;
* **modulo schedulability** — the chosen labels admit absolute times
  ``t ≡ label (mod II)`` satisfying every dependency ``t_v ≥ t_u + 1 − II·d``
  (checked by Bellman–Ford over residue-rounded edge weights — the
  quotient/remainder split of the DRMT-style ILP encodings, with the
  quotients eliminated instead of branched).

Domains are per-label PE bitmasks in the DESIGN.md §5 layout, propagated by
forward checking; symmetry is broken by pinning the highest-degree node to
label 0 (global schedule rotation) and to one PE per grid-automorphism orbit.
The search is exhaustive, so ``unsat`` is a proof; budgets make the answer
``unknown`` instead of wrong. Everything is stdlib-only and deterministic
under ``node_budget`` (the certify/CI mode).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

from ..cgra import CGRA, op_class
from ..dfg import DFG
from ..mapper import Mapping

__all__ = ["JointOutcome", "solve_joint", "grid_automorphisms"]

#: How often (in visited nodes) the wall deadline is polled.
_DEADLINE_STRIDE = 1024


@dataclass
class JointOutcome:
    """Result of one :func:`solve_joint` call at a fixed II.

    ``status`` is ``"sat"`` (a mapping exists — ``mapping`` carries it when
    the search ran with direct adjacency), ``"unsat"`` (exhaustive proof that
    none exists), or ``"unknown"`` (budget exhausted first). ``unsat`` under
    ``reach_hops > 1`` is still a sound impossibility proof for the *relaxed*
    model, hence a valid lower bound for route-through mappings; ``sat``
    there proves nothing about real (mov-realised) mappings, so ``mapping``
    is None.
    """

    status: str
    ii: int
    nodes_visited: int = 0
    wall_s: float = 0.0
    reach_hops: int = 1
    mapping: Mapping | None = None


class _Budget(Exception):
    """Internal: node budget or deadline exhausted mid-search."""


def grid_automorphisms(cgra: CGRA) -> list[tuple[int, ...]]:
    """PE permutations preserving adjacency, capabilities and registers.

    Candidates are the grid's coordinate symmetries — the dihedral
    reflections/transposes, plus every row/column translation on a torus —
    filtered against the *actual* ``closed_masks`` / ``capability_masks`` /
    ``registers_at`` data, so heterogeneous fabrics only keep the symmetries
    their capability layout survives. Used to shrink the root node's PE
    domain to one representative per orbit (§14.2); always contains the
    identity.
    """
    rows, cols, n = cgra.rows, cgra.cols, cgra.num_pes
    candidates: set[tuple[int, ...]] = set()
    shifts = (
        [(dr, dc) for dr in range(rows) for dc in range(cols)]
        if cgra.topology == "torus" else [(0, 0)]
    )
    for flip_r in (False, True):
        for flip_c in (False, True):
            for transpose in (False, True):
                if transpose and rows != cols:
                    continue
                for dr, dc in shifts:
                    perm = []
                    for p in range(n):
                        r, c = cgra.pe_coords(p)
                        if flip_r:
                            r = rows - 1 - r
                        if flip_c:
                            c = cols - 1 - c
                        if transpose:
                            r, c = c, r
                        perm.append(
                            cgra.pe_index((r + dr) % rows, (c + dc) % cols)
                        )
                    candidates.add(tuple(perm))

    def permuted_mask(mask: int, perm: tuple[int, ...]) -> int:
        out = 0
        while mask:
            bit = mask & -mask
            out |= 1 << perm[bit.bit_length() - 1]
            mask ^= bit
        return out

    closed = cgra.closed_masks
    caps = cgra.capability_masks
    out = []
    for perm in sorted(candidates):
        if any(permuted_mask(closed[p], perm) != closed[perm[p]]
               for p in range(n)):
            continue
        if any(permuted_mask(m, perm) != m for m in caps.values()):
            continue
        if any(cgra.registers_at(p) != cgra.registers_at(perm[p])
               for p in range(n)):
            continue
        out.append(perm)
    return out


def _orbit_representatives(cgra: CGRA) -> int:
    """Bitmask of one minimal PE per orbit of the automorphism group."""
    perms = grid_automorphisms(cgra)
    mask = 0
    for p in range(cgra.num_pes):
        if min(perm[p] for perm in perms) == p:
            mask |= 1 << p
    return mask


def _rounded_weights(
    dfg: DFG, ii: int
) -> list[tuple[int, int, int]]:
    """The raw difference constraints ``t_dst − t_src ≥ 1 − II·d``."""
    return [(e.src, e.dst, 1 - ii * e.distance) for e in dfg.edges]


def _schedulable(
    labels: list[int], edges: list[tuple[int, int, int]], ii: int, n: int
) -> bool:
    """Can absolute times ``t ≡ label (mod II)`` satisfy every dependency?

    For an edge with both endpoints labelled, the weight rounds up to the
    smallest value congruent to ``label[dst] − label[src] (mod II)`` — a
    *constant* once labels are fixed, so this is plain Bellman–Ford
    longest-path; a positive cycle (still relaxing after ``n`` passes) means
    the partial labelling admits no schedule at this II.
    """
    dist = [0] * n
    for _ in range(n + 1):
        changed = False
        for s, d, w in edges:
            ls, ld = labels[s], labels[d]
            if ls >= 0 and ld >= 0:
                w += (ld - ls - w) % ii
            nd = dist[s] + w
            if nd > dist[d]:
                dist[d] = nd
                changed = True
        if not changed:
            return True
    return False


def _realize_times(
    labels: list[int], edges: list[tuple[int, int, int]], ii: int, n: int
) -> list[int]:
    """Minimal nonnegative ``t_abs`` with ``t ≡ label (mod II)`` per node."""
    t = list(labels)
    for _ in range(n + 1):
        changed = False
        for s, d, w in edges:
            lo = t[s] + w
            if t[d] < lo:
                t[d] = lo + ((t[d] - lo) % ii)
                changed = True
        if not changed:
            break
    return t


def solve_joint(
    dfg: DFG,
    cgra: CGRA,
    ii: int,
    *,
    reach_hops: int = 1,
    node_budget: int | None = None,
    deadline_s: float | None = None,
) -> JointOutcome:
    """Decide whether *any* mapping of ``dfg`` on ``cgra`` exists at ``ii``.

    Exhaustive joint search (module docstring); ``node_budget`` bounds
    visited assignments (the deterministic knob), ``deadline_s`` bounds wall
    time. ``reach_hops=1`` is the paper's direct-routability model and the
    only mode that returns a :class:`Mapping` on ``sat``; ``reach_hops =
    1 + max_route_hops`` is the §14.3 relaxation whose ``unsat`` answers
    bound route-through mappings from below.
    """
    if ii < 1:
        raise ValueError(f"ii must be >= 1, got {ii}")
    if reach_hops < 1:
        raise ValueError(f"reach_hops must be >= 1, got {reach_hops}")
    dfg.validate()
    start = _time.perf_counter()
    n, num_pes = dfg.num_nodes, cgra.num_pes

    def done(status: str, visited: int, mapping: Mapping | None = None):
        return JointOutcome(
            status=status, ii=ii, nodes_visited=visited,
            wall_s=_time.perf_counter() - start, reach_hops=reach_hops,
            mapping=mapping,
        )

    # ---- free structural unsat proofs (these ARE the res/rec bounds) ----
    classes = [op_class(op) for op in dfg.ops]
    counts: dict[str, int] = {}
    for cls in classes:
        counts[cls] = counts.get(cls, 0) + 1
    if n > num_pes * ii:
        return done("unsat", 0)
    for cls, cnt in counts.items():
        if cnt > cgra.class_capacity(cls) * ii:
            return done("unsat", 0)
    edges = _rounded_weights(dfg, ii)
    if not _schedulable([-1] * n, edges, ii, n):   # II < RecII
        return done("unsat", 0)

    reach = (cgra.closed_masks if reach_hops == 1
             else cgra.reach_masks(reach_hops))
    cap_mask = [cgra.capability_masks[c] for c in classes]
    und = [sorted(s) for s in dfg.undirected_adjacency()]
    mem_cap = cgra.class_capacity("mem")
    track_mem = (cgra.mem_ports is not None
                 and "mem" in counts and mem_cap < counts["mem"] + 1)
    mem_nodes = [v for v in range(n) if classes[v] == "mem"]

    # ---- domains: per node, a PE bitmask per label (§5 bit layout) ----
    dom: list[list[int]] = [[cap_mask[v]] * ii for v in range(n)]
    cnt = [cap_mask[v].bit_count() * ii for v in range(n)]
    labels = [-1] * n
    place = [-1] * n
    mem_at = [0] * ii

    # symmetry root: highest-degree node, pinned to label 0 and one PE per
    # grid-automorphism orbit (any solution rotates/reflects onto this form)
    root = max(range(n), key=lambda v: (len(und[v]), -v))
    reps = _orbit_representatives(cgra) & cap_mask[root]
    if reps == 0:
        return done("unsat", 0)
    for k in range(ii):
        dom[root][k] = reps if k == 0 else 0
    cnt[root] = reps.bit_count()

    trail: list[tuple[int, int, int]] = []     # (node, label, old mask)
    visited = 0
    budget = node_budget if node_budget is not None else float("inf")
    deadline = (None if deadline_s is None else start + deadline_s)

    def shrink(v: int, k: int, new_mask: int) -> bool:
        """Record + apply one domain write; False on wipeout."""
        old = dom[v][k]
        if new_mask == old:
            return True
        trail.append((v, k, old))
        dom[v][k] = new_mask
        cnt[v] += new_mask.bit_count() - old.bit_count()
        return cnt[v] > 0

    def propagate(v: int, k: int, p: int) -> bool:
        bit = 1 << p
        for u in range(n):                      # slot exclusivity
            if labels[u] < 0 and u != v and dom[u][k] & bit:
                if not shrink(u, k, dom[u][k] & ~bit):
                    return False
        r = reach[p]
        for u in und[v]:                        # adjacency
            if labels[u] < 0:
                for j in range(ii):
                    if dom[u][j] & ~r:
                        if not shrink(u, j, dom[u][j] & r):
                            return False
        if track_mem and classes[v] == "mem":
            mem_at[k] += 1
            if mem_at[k] >= mem_cap:            # step's ports are full
                for u in mem_nodes:
                    if labels[u] < 0 and dom[u][k]:
                        if not shrink(u, k, 0):
                            return False
        return _schedulable(labels, edges, ii, n)

    def search(depth: int) -> bool:
        nonlocal visited
        if depth == n:
            return True
        v = -1
        best = None
        for u in range(n):
            if labels[u] < 0:
                key = (cnt[u], -len(und[u]), u)
                if best is None or key < best:
                    best, v = key, u
        mark = len(trail)
        mem_mark = mem_at[0:] if track_mem else None
        for k in range(ii):
            mask = dom[v][k]
            while mask:
                bit = mask & -mask
                mask ^= bit
                p = bit.bit_length() - 1
                visited += 1
                if visited > budget:
                    raise _Budget
                if deadline is not None and visited % _DEADLINE_STRIDE == 0 \
                        and _time.perf_counter() > deadline:
                    raise _Budget
                labels[v], place[v] = k, p
                if propagate(v, k, p) and search(depth + 1):
                    return True
                labels[v] = place[v] = -1
                while len(trail) > mark:       # undo this value's writes
                    u, j, old = trail.pop()
                    cnt[u] += old.bit_count() - dom[u][j].bit_count()
                    dom[u][j] = old
                if track_mem:
                    mem_at[:] = mem_mark
        return False

    try:
        sat = search(0)
    except _Budget:
        return done("unknown", visited)
    except RecursionError:                      # pragma: no cover
        return done("unknown", visited)
    if not sat:
        return done("unsat", visited)
    mapping = None
    if reach_hops == 1:
        t_abs = _realize_times(labels, edges, ii, n)
        mapping = Mapping(
            dfg=dfg, cgra=cgra, ii=ii, t_abs=t_abs, placement=list(place)
        )
    return done("sat", visited, mapping)
