"""Backend protocol, problem container and registry for the time phase.

A backend enumerates time solutions (absolute schedule ``t_abs`` per node) for
a fixed (DFG, CGRA, II, window) problem, one per call, never repeating a
*kernel-label partition* (``t mod II`` per node): the space phase depends only
on the partition, so a partition that failed to embed once will fail again and
must not be re-proposed. Backends are resumable — a call that runs out of
budget (``deadline`` / ``step_budget``) returns None while keeping its search
state, and the next call continues where it stopped; ``exhausted`` is only set
when the whole space is proven empty.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Protocol


@dataclass(frozen=True)
class TimeProblem:
    """Everything a time backend needs, precomputed once by TimeSolver."""

    num_nodes: int
    edges: tuple[tuple[int, int, int], ...]   # (src, dst, distance)
    adj: tuple[frozenset[int], ...]           # undirected DFG adjacency
    ii: int
    asap: tuple[int, ...]                     # modulo-aware window low
    alap: tuple[int, ...]                     # modulo-aware window high
    cap: int                                  # PEs: capacity per kernel step
    # connectivity degree: D_M on a direct-only search; the relaxed closed
    # ≤(1+route_hops)-step reach degree when the mapper allows route-through
    # (TimeSolver(route_hops=...), DESIGN.md §12.3) — the paper's D_M bound
    # is not a necessary condition once edges may ride mov chains.
    d_m: int
    strict: bool                              # strict connectivity mode
    seed: int = 0
    # per-op-class capacities (DESIGN.md §10): (class name, per-step capacity,
    # member node ids). Only classes whose capacity is strictly below ``cap``
    # appear — the global capacity bound subsumes the rest, and an empty tuple
    # keeps the homogeneous constraint set bit-identical to the paper's.
    class_caps: tuple[tuple[str, int, tuple[int, ...]], ...] = ()
    # triangle exclusion (strict mode) is only sound on triangle-free PE
    # graphs: False for diagonal/one-hop grids and 3-rings of a torus.
    triangle_free: bool = True


class TimeBackend(Protocol):  # pragma: no cover - typing only
    name: str
    exhausted: bool

    def next_solution(
        self, *, deadline: float | None = None, step_budget: int | None = None
    ) -> list[int] | None: ...

    def block(self, labels: list[int]) -> None: ...


class BackendUnavailable(RuntimeError):
    """Requested backend exists but its dependency is not importable."""


@dataclass
class _BackendSpec:
    name: str
    factory: Callable[..., "TimeBackend"]
    available: Callable[[], bool]
    aliases: tuple[str, ...] = ()


_REGISTRY: dict[str, _BackendSpec] = {}
_ALIASES: dict[str, str] = {}


def register_backend(
    name: str,
    factory: Callable[..., "TimeBackend"],
    available: Callable[[], bool],
    *,
    aliases: tuple[str, ...] = (),
) -> None:
    spec = _BackendSpec(name, factory, available, aliases)
    _REGISTRY[name] = spec
    for a in aliases:
        _ALIASES[a] = name


def resolve_backend_name(name: str) -> str:
    """Canonicalise an alias/auto request to a concrete registered backend."""
    if name == "auto":
        for candidate in ("z3", "cp"):
            if candidate in _REGISTRY and _REGISTRY[candidate].available():
                return candidate
        raise BackendUnavailable("no time backend available")
    name = _ALIASES.get(name, name)
    if name not in _REGISTRY:
        raise ValueError(f"unknown time backend {name!r}")
    return name


def available_backends() -> dict[str, bool]:
    """Backend name -> importable right now. For diagnostics and tests."""
    return {n: spec.available() for n, spec in _REGISTRY.items()}


def create_backend(
    name: str, problem: TimeProblem, *, timeout_s: float | None = None
) -> "TimeBackend":
    name = resolve_backend_name(name)
    spec = _REGISTRY[name]
    if not spec.available():
        raise BackendUnavailable(f"time backend {name!r} is not importable")
    return spec.factory(problem, timeout_s=timeout_s)


def residue_window(lo: int, hi: int, k: int, ii: int) -> tuple[int, int] | None:
    """Min/max t in [lo, hi] with t ≡ k (mod ii), or None if the class is
    empty. The congruence rounding here underpins both the CP label domains
    and the re-realization passes — keep it in one place."""
    first = lo + ((k - lo) % ii)
    if first > hi:
        return None
    return first, first + ((hi - first) // ii) * ii


def mov_slot_headroom(labels, ii: int, cap: int) -> list[int]:
    """Free-slot count per kernel step for a realized label assignment.

    The slot/cardinality accounting shared by the route-through materializer
    (core/mono.py) when it re-labels a partition by inserting ``mov`` nodes:
    a mov occupies a real (PE, step) slot, so a step may only absorb one when
    its load is below ``cap`` (the per-step capacity both backends enforce
    for the original nodes). Per-class caps need no extra row here — a mov is
    ``alu`` work placed on a concrete capable free PE, and distinct-PE
    occupancy is a witness that every cardinality constraint still holds.
    """
    load = [0] * ii
    for k in labels:
        load[k % ii] += 1
    return [cap - c for c in load]


def triangles(adj) -> list[tuple[int, int, int]]:
    """All triangles {u<v<w} of an undirected adjacency list of sets.

    Mesh/torus PE graphs are bipartite => triangle-free, so three mutually
    adjacent DFG nodes can never share a kernel step; strict-mode backends
    exclude such partitions up front (DESIGN.md §7).
    """
    out: list[tuple[int, int, int]] = []
    for u in range(len(adj)):
        for v in adj[u]:
            if v <= u:
                continue
            for w in adj[u] & adj[v]:
                if w > v:
                    out.append((u, v, w))
    return out
