"""CGRA architecture model and MRRG construction (paper §III, §IV-A).

The target architecture (paper §V, and its §V-3 limitation) is an R×C grid of
PEs where every PE can read the register files of its mesh neighbours and its
own. A produced value persists in the producer's register file, so a dependency
u→v is spatially routable iff PE(u) is PE(v) itself or a neighbour — regardless
of the time gap (modulo the II wrap for loop-carried deps). This is what makes
the paper's space/time decoupling sound, and it is the architecture we model.

``topology`` extends the paper's mesh with three variants: ``torus`` (the
mesh with wrap-around links), ``diagonal`` (king-move mesh: the
4-neighbourhood plus diagonals, as in SAT-MapIt-style CGRAs) and ``one-hop``
(mesh plus distance-2 row/column links).

Heterogeneity (paper §V-3's flagged assumption, lifted here): each PE carries
a set of *capability classes* — ``alu`` (plain arithmetic/logic), ``mem``
(loads/stores), ``mul`` (multiply/divide) — and a grid-level memory-port
count bounds how many memory ops may fire per cycle. The default
``CGRA(r, c)`` stays the paper's homogeneous grid (every PE every class, no
port bound); declarative specs live in ``core/arch`` (DESIGN.md §10).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from functools import cached_property

# ---------------------------------------------------------------- op classes

#: The capability-class universe. A PE executes an op iff the op's class is in
#: the PE's class set; ``core/arch`` presets compose grids from these.
CAP_CLASSES = ("alu", "mem", "mul")

# op -> capability class. Anything not listed (arith/logic/moves/phi/inputs)
# is plain "alu" work every PE can do.
_OP_CLASS = {"load": "mem", "store": "mem", "mul": "mul", "div": "mul"}


def op_class(op: str) -> str:
    """Capability class an op needs: ``mem`` | ``mul`` | ``alu``."""
    return _OP_CLASS.get(op, "alu")


class _AdjacencyRow:
    """One lazy row of the closed-adjacency predicate: bool per PE."""

    __slots__ = ("_mask", "_n")

    def __init__(self, mask: int, n: int) -> None:
        self._mask = mask
        self._n = n

    def __getitem__(self, pe: int) -> bool:
        if not 0 <= pe < self._n:
            raise IndexError(pe)
        return bool(self._mask >> pe & 1)

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        m, n = self._mask, self._n
        return (bool(m >> p & 1) for p in range(n))


class _AdjacencyView:
    """Lazy ``adjacency[u][v]`` view over ``closed_masks`` (no N×N table)."""

    __slots__ = ("_masks",)

    def __init__(self, masks: tuple[int, ...]) -> None:
        self._masks = masks

    def __getitem__(self, pe: int) -> _AdjacencyRow:
        return _AdjacencyRow(self._masks[pe], len(self._masks))

    def __len__(self) -> int:
        return len(self._masks)

    def __iter__(self):
        return (self[p] for p in range(len(self._masks)))


_TOPOLOGIES = ("mesh", "torus", "diagonal", "one-hop")

# neighbour offsets per non-torus topology (torus wraps the mesh offsets)
_OFFSETS = {
    "mesh": ((1, 0), (-1, 0), (0, 1), (0, -1)),
    "diagonal": (
        (1, 0), (-1, 0), (0, 1), (0, -1),
        (1, 1), (1, -1), (-1, 1), (-1, -1),
    ),
    "one-hop": (
        (1, 0), (-1, 0), (0, 1), (0, -1),
        (2, 0), (-2, 0), (0, 2), (0, -2),
    ),
}


@dataclass(frozen=True)
class CGRA:
    """An R×C grid of single-cycle PEs with neighbour-readable register files.

    This is the spatial half of every mapping: the monomorphism search embeds
    a labelled DFG into ``MRRG(cgra, II)``, and a dependency u→v is routable
    iff ``placement[u]`` is closed-adjacent to ``placement[v]`` (DESIGN.md
    §2). Instances are frozen (hashable, picklable across service workers)
    and precompute their adjacency as bitmasks (DESIGN.md §5).

    ``pe_classes`` makes the grid heterogeneous: entry p is the tuple of
    capability classes PE p supports (see ``CAP_CLASSES``), and ``mem_ports``
    optionally bounds memory ops per cycle grid-wide. ``None`` (the default)
    means the paper's homogeneous machine — every PE supports every class —
    so all pre-existing callers are unchanged. The architecture presets are
    not ported yet; :mod:`repro_torch.interop` carries a heterogeneous grid
    over field by field.

    Example::

        from repro_torch.core import CGRA

        cgra = CGRA(4, 4)                   # paper's mesh
        assert cgra.num_pes == 16
        assert cgra.connectivity_degree == 5    # D_M: self + 4 neighbours
        torus = CGRA(4, 4, topology="torus")    # wrap-around variant
        assert all(len(n) == 4 for n in torus.neighbors)
        king = CGRA(4, 4, topology="diagonal")  # adds diagonal links
        assert king.connectivity_degree == 9 and not king.triangle_free
    """

    rows: int
    cols: int
    topology: str = "mesh"          # "mesh" (paper) | "torus" | "diagonal" | "one-hop"
    registers_per_pe: int = 8       # enforced by Mapping.validate's pressure probe
    # per-PE capability classes; None = homogeneous (every PE, every class)
    pe_classes: tuple[tuple[str, ...], ...] | None = None
    # max memory ops per cycle grid-wide; None = one port per mem-capable PE
    mem_ports: int | None = None
    # per-capability-class register-file override, ((class, count), ...);
    # a dict is accepted and normalised. None = the scalar registers_per_pe
    registers_by_class: tuple[tuple[str, int], ...] | None = None

    def __post_init__(self) -> None:
        if self.rows < 1 or self.cols < 1:
            raise ValueError("CGRA must have at least one PE")
        if self.topology not in _TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}")
        if self.registers_by_class is not None:
            # normalise dicts (and unsorted tuples) so equality/hashing work
            items = (self.registers_by_class.items()
                     if isinstance(self.registers_by_class, dict)
                     else self.registers_by_class)
            norm = tuple(sorted((str(c), int(n)) for c, n in items))
            for c, n in norm:
                if c not in CAP_CLASSES:
                    raise ValueError(
                        f"registers_by_class: unknown capability class {c!r}"
                    )
                if n < 1:
                    raise ValueError(
                        f"registers_by_class[{c!r}] must be >= 1, got {n}"
                    )
            object.__setattr__(self, "registers_by_class", norm)
        if self.pe_classes is not None:
            if len(self.pe_classes) != self.num_pes:
                raise ValueError(
                    f"pe_classes has {len(self.pe_classes)} entries for "
                    f"{self.num_pes} PEs"
                )
            for p, classes in enumerate(self.pe_classes):
                if not classes:
                    raise ValueError(f"PE {p} has no capability classes")
                for c in classes:
                    if c not in CAP_CLASSES:
                        raise ValueError(f"PE {p}: unknown capability class {c!r}")
        if self.mem_ports is not None and self.mem_ports < 0:
            raise ValueError("mem_ports must be >= 0")

    @property
    def num_pes(self) -> int:
        return self.rows * self.cols

    def pe_index(self, r: int, c: int) -> int:
        return r * self.cols + c

    def pe_coords(self, pe: int) -> tuple[int, int]:
        return divmod(pe, self.cols)

    @cached_property
    def neighbors(self) -> tuple[tuple[int, ...], ...]:
        """Topology neighbours of each PE, *excluding* the PE itself."""
        offsets = _OFFSETS["mesh" if self.topology == "torus" else self.topology]
        out: list[tuple[int, ...]] = []
        for pe in range(self.num_pes):
            r, c = self.pe_coords(pe)
            nbrs: set[int] = set()
            for dr, dc in offsets:
                rr, cc = r + dr, c + dc
                if self.topology == "torus":
                    rr %= self.rows
                    cc %= self.cols
                    if (rr, cc) != (r, c):
                        nbrs.add(self.pe_index(rr, cc))
                elif 0 <= rr < self.rows and 0 <= cc < self.cols:
                    nbrs.add(self.pe_index(rr, cc))
            out.append(tuple(sorted(nbrs)))  # sorted for determinism
        return tuple(out)

    @cached_property
    def adjacency(self) -> "_AdjacencyView":
        """Closed adjacency (self-loop included): routability predicate.

        Indexed like the historical dense matrix (``adjacency[u][v]`` is a
        bool) but evaluated lazily over ``closed_masks`` — a 100×100 fabric
        would need a 10⁸-entry materialised matrix, which is what capped the
        supported fabric size before the space-backend split (DESIGN.md §13).
        """
        return _AdjacencyView(self.closed_masks)

    @cached_property
    def closed_masks(self) -> tuple[int, ...]:
        """Closed neighbourhood of each PE as a bitmask (bit p = PE p).

        The layout contract shared with core/mono.py (DESIGN.md §5): PE p is
        bit ``1 << p``, so candidate-set intersection, occupancy tests and
        free-slot counting are word-level AND/ANDN/popcount instead of
        per-element Python set operations.
        """
        out: list[int] = []
        for pe in range(self.num_pes):
            m = 1 << pe
            for nb in self.neighbors[pe]:
                m |= 1 << nb
            out.append(m)
        return tuple(out)

    @cached_property
    def _reach_cache(self) -> dict[int, tuple[int, ...]]:
        return {1: self.closed_masks}

    def reach_masks(self, hops: int) -> tuple[int, ...]:
        """Closed ≤``hops``-step reachability masks (same §5 bit layout).

        ``reach_masks(1)`` is exactly ``closed_masks``; ``reach_masks(h)[p]``
        is every PE reachable from p by chaining at most ``h`` closed-adjacency
        steps. This is the relaxed routability predicate of the route-through
        space search (DESIGN.md §12): an edge placed at hop distance ``h > 1``
        is later realised by splicing ``h - 1`` ``mov`` nodes onto the path.
        """
        if hops < 1:
            raise ValueError(f"hops must be >= 1, got {hops}")
        cache = self._reach_cache
        if hops not in cache:
            prev = self.reach_masks(hops - 1)
            closed = self.closed_masks
            out: list[int] = []
            for pe in range(self.num_pes):
                m, acc = prev[pe], prev[pe]
                while m:
                    b = m & -m
                    acc |= closed[b.bit_length() - 1]
                    m ^= b
                out.append(acc)
            cache[hops] = tuple(out)
        return cache[hops]

    def reach_degree(self, hops: int) -> int:
        """Max closed ≤``hops``-step neighbourhood size: the D_M analogue the
        time phase must use when route-through is allowed (DESIGN.md §12.3)."""
        return max(m.bit_count() for m in self.reach_masks(hops))

    @property
    def connectivity_degree(self) -> int:
        """Paper's D_M: max closed neighbourhood size (self + mesh neighbours).

        D_M = 3 for 2x2, 5 for 3x3 and larger meshes, matching §IV-B3.
        Diagonal and one-hop grids have larger closed neighbourhoods (up to 9).
        """
        return max(len(n) for n in self.neighbors) + 1

    @cached_property
    def triangle_free(self) -> bool:
        """True iff the PE graph has no 3-clique.

        The strict-mode triangle exclusion (DESIGN.md §7) is only sound on
        triangle-free PE graphs: plain meshes are bipartite, but diagonal
        (king-move) grids, one-hop grids, and tori with a ring of length 3
        all contain triangles, so three mutually adjacent DFG nodes *can*
        share a kernel step there. Computed from the actual neighbour lists
        rather than the topology name so every current and future family is
        handled by construction.
        """
        for pe in range(self.num_pes):
            nbrs = self.neighbors[pe]
            for i, a in enumerate(nbrs):
                if a < pe:
                    continue
                for b in nbrs[i + 1:]:
                    if a in self.neighbors[b]:
                        return False
        return True

    # -------------------------------------------------------------- capability
    @property
    def heterogeneous(self) -> bool:
        """True when capabilities or memory ports deviate from the paper model."""
        return self.pe_classes is not None or self.mem_ports is not None

    @cached_property
    def capability_masks(self) -> dict[str, int]:
        """Per capability class, the bitmask of capable PEs (bit p = PE p).

        Shares the DESIGN.md §5 layout contract with ``closed_masks`` so the
        space engine can intersect a node's candidate set with its op-class
        mask in one AND. Homogeneous grids map every class to the full mask.
        """
        full = (1 << self.num_pes) - 1
        if self.pe_classes is None:
            return {c: full for c in CAP_CLASSES}
        masks = {c: 0 for c in CAP_CLASSES}
        for pe, classes in enumerate(self.pe_classes):
            for c in classes:
                masks[c] |= 1 << pe
        return masks

    def capable(self, pe: int, cls: str) -> bool:
        """Can PE ``pe`` execute ops of capability class ``cls``?"""
        return bool(self.capability_masks[cls] >> pe & 1)

    def class_capacity(self, cls: str) -> int:
        """Per-kernel-step capacity of a class: capable-PE count, and for
        ``mem`` additionally clamped by the grid's memory-port count."""
        cap = self.capability_masks[cls].bit_count()
        if cls == "mem" and self.mem_ports is not None:
            cap = min(cap, self.mem_ports)
        return cap

    @cached_property
    def _registers_at(self) -> tuple[int, ...]:
        overrides = dict(self.registers_by_class or ())
        out = []
        for pe in range(self.num_pes):
            classes = (CAP_CLASSES if self.pe_classes is None
                       else self.pe_classes[pe])
            out.append(max(
                overrides.get(c, self.registers_per_pe) for c in classes
            ))
        return tuple(out)

    def registers_at(self, pe: int) -> int:
        """Register-file size of PE ``pe``.

        ``registers_by_class`` (core/arch: SAT-MapIt-style machines size
        memory-PE buffers differently) overrides the scalar
        ``registers_per_pe`` per capability class; a PE carrying several
        classes gets the largest file its classes demand. Without overrides
        every PE answers ``registers_per_pe`` — the paper's machine.
        """
        return self._registers_at[pe]

    def unsupported_ops(self, dfg) -> list[str]:
        """Ops of ``dfg`` that no PE (or port budget) can ever execute.

        The mapper fails fast on a non-empty result instead of exhausting
        its (II, slack) window sweep on a structurally impossible target.
        """
        errs: list[str] = []
        seen: set[str] = set()
        for v in range(dfg.num_nodes):
            cls = op_class(dfg.ops[v])
            if cls in seen:
                continue
            seen.add(cls)
            if self.class_capacity(cls) == 0:
                errs.append(
                    f"op {dfg.ops[v]!r} (class {cls!r}) has no capable PE on {self}"
                )
        return errs

    def arch_token(self) -> str | None:
        """Cache-key component identifying the heterogeneous architecture.

        ``None`` for the paper's homogeneous grid (dims/topology already key
        those), a short digest of the capability layout otherwise — folded
        into both mapping-cache keys (DESIGN.md §9) so heterogeneous and
        homogeneous mappings of the same DFG never alias.
        """
        if not self.heterogeneous:
            return None
        payload = json.dumps(
            {
                "classes": [sorted(c) for c in self.pe_classes or []],
                "mem_ports": self.mem_ports,
            },
            sort_keys=True,
            separators=(",", ":"),
        )
        return hashlib.sha1(payload.encode()).hexdigest()[:16]

    def pressure_token(self, max_register_pressure: int | None):
        """Cache-key component for the *effective* per-PE register bounds.

        The mapper's ``max_register_pressure`` guarantee is per-PE:
        ``min(max_register_pressure, registers_at(pe))`` for every PE. Two
        grids of the same shape but different register sizing therefore admit
        different mappings under the same scalar limit, so the scalar alone
        must never key the mapping caches.
        ``None`` when the guarantee is off (mappings are then
        register-agnostic); the scalar bound when every PE's effective bound
        collapses to one value; a digest of the full bound vector otherwise.
        """
        if max_register_pressure is None:
            return None
        bounds = tuple(
            min(max_register_pressure, r) for r in self._registers_at
        )
        if len(set(bounds)) == 1:
            return bounds[0]
        payload = json.dumps(list(bounds), separators=(",", ":"))
        return hashlib.sha1(payload.encode()).hexdigest()[:16]

    def __str__(self) -> str:  # pragma: no cover
        het = ",hetero" if self.heterogeneous else ""
        return f"CGRA({self.rows}x{self.cols},{self.topology}{het})"


@dataclass(frozen=True)
class MRRG:
    """Modulo Routing Resource Graph: II stacked copies of the CGRA (§IV-A).

    Vertices are (pe, t) with t in [0, II). l_M((pe, t)) = t. Spatial edges
    connect PEs adjacent in the CGRA at equal time; time edges connect a PE's
    closed neighbourhood across consecutive steps (values persisting in
    register files make any time gap routable, which we encode directly in the
    ``routable`` predicate used by the monomorphism search instead of
    materialising the transitive closure).
    """

    cgra: CGRA
    ii: int

    @property
    def num_vertices(self) -> int:
        return self.cgra.num_pes * self.ii

    def vertex(self, pe: int, t: int) -> int:
        return t * self.cgra.num_pes + pe

    def vertex_pe_time(self, v: int) -> tuple[int, int]:
        t, pe = divmod(v, self.cgra.num_pes)
        return pe, t

    def label(self, v: int) -> int:
        return v // self.cgra.num_pes

    def routable(self, pe_u: int, pe_v: int) -> bool:
        """Edge-existence predicate used by mono3: closed mesh adjacency."""
        return self.cgra.adjacency[pe_u][pe_v]

    def edges(self):
        """Materialised undirected edge set {(pe,t),(pe',t')} per the paper.

        Spatial edges at each step + time edges between consecutive steps
        (including the II wrap, since the kernel repeats). Only used by tests
        and visualisation; the search uses ``routable``.
        """
        n = self.cgra.num_pes
        for t in range(self.ii):
            for pe in range(n):
                for nb in self.cgra.neighbors[pe]:
                    if pe < nb:
                        yield (self.vertex(pe, t), self.vertex(nb, t))
            t2 = (t + 1) % self.ii
            if t2 == t:
                continue
            for pe in range(n):
                # self-loop across time + neighbour reads across time
                yield (self.vertex(pe, t), self.vertex(pe, t2))
                for nb in self.cgra.neighbors[pe]:
                    yield (self.vertex(pe, t), self.vertex(nb, t2))
