"""Window space backend: the exact engine on a sub-mesh of a large fabric.

What ``"auto"`` resolves to on a homogeneous mesh of more than
:data:`AUTO_EXACT_MAX_PES` PEs (DESIGN.md §13.3). A probe runs in two steps:

1. the ``exact`` engine on the centred sub-mesh window of at most
   :data:`AUTO_EXACT_MAX_PES` PEs (20×20 on a 50×50 mesh), with the probe's
   own budget; its placement is translated into the full fabric's PE ids;
2. only where that finds nothing, the ``anneal`` engine on the whole fabric,
   with what is left of the probe's budget.

Step 1 is sound because a window of a mesh without wrap-around links is a
mesh whose links all exist in the full fabric: a placement, and each mov
chain of a route-through, that is legal in the window is legal on the whole
fabric. So on a large mesh every partition the exact engine embeds on 20×20
is embedded by the same search, at the same cost in visited nodes, instead
of being left to the incomplete annealer.

Other fabrics have no window, and the engine refuses them: a
heterogeneous grid's window would change which PEs are capable of what, a
torus window would keep wrap-around links the fabric lacks, and diagonal
and one-hop windows have not been checked. ``"auto"`` resolves to this
engine only where :func:`has_window` holds.
"""

from __future__ import annotations

import dataclasses
import time as _time
from functools import lru_cache
from math import isqrt

from ... import obs
from ..cgra import CGRA
from ..dfg import DFG
from .anneal import AnnealSpaceBackend
from .base import (
    AUTO_EXACT_MAX_PES,
    MaterializedRoute,
    SpaceBudget,
    SpaceSolution,
    SpaceStats,
    register_space_backend,
)
from .exact import ExactSpaceBackend


def has_window(cgra: CGRA) -> bool:
    """Whether the window engine searches a sub-mesh of ``cgra``: a
    homogeneous mesh of more than :data:`AUTO_EXACT_MAX_PES` PEs, whose
    windows are meshes with every link in the fabric."""
    return (cgra.num_pes > AUTO_EXACT_MAX_PES and cgra.topology == "mesh"
            and not cgra.heterogeneous)


@lru_cache(maxsize=8)
def window_of(cgra: CGRA) -> tuple[CGRA, int, int]:
    """The centred sub-mesh of ``cgra`` with at most
    :data:`AUTO_EXACT_MAX_PES` PEs, as ``(window, row offset, col offset)``.

    As square as the fabric allows: 20×20 on a 50×50 or a 21×20 mesh; a
    fabric narrower than 20 keeps its width and takes as many rows as fit.
    """
    side = isqrt(AUTO_EXACT_MAX_PES)
    rows = min(cgra.rows, side)
    cols = min(cgra.cols, AUTO_EXACT_MAX_PES // rows)
    rows = min(cgra.rows, AUTO_EXACT_MAX_PES // cols)
    window = dataclasses.replace(cgra, rows=rows, cols=cols)
    return window, (cgra.rows - rows) // 2, (cgra.cols - cols) // 2


#: the SpaceStats fields that count work, summed over the two steps
_COUNTS = ("search_time_s", "nodes_visited", "backtracks", "restarts",
           "route_failures", "deadline_stops", "budget_stops")


def _merge(into: SpaceStats, part: SpaceStats) -> None:
    for name in _COUNTS:
        setattr(into, name, getattr(into, name) + getattr(part, name))


def _rest(budget: SpaceBudget, elapsed_s: float, nodes: int) -> SpaceBudget | None:
    """What is left of ``budget`` after ``elapsed_s`` seconds and ``nodes``
    visited nodes; None where nothing is."""
    timeout = None if budget.timeout_s is None else budget.timeout_s - elapsed_s
    node_budget = None if budget.node_budget is None else budget.node_budget - nodes
    if (timeout is not None and timeout <= 0) or (node_budget is not None
                                                  and node_budget <= 0):
        return None
    return SpaceBudget(timeout_s=timeout, node_budget=node_budget,
                       restarts=budget.restarts)


class WindowSpaceBackend:
    """The exact engine on the centred window, then anneal on the fabric."""

    name = "window"

    def __init__(self) -> None:
        self._exact = ExactSpaceBackend()
        self._anneal = AnnealSpaceBackend()

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
        if not has_window(cgra):
            raise ValueError(
                f"the window engine needs a homogeneous mesh of more than "
                f"{AUTO_EXACT_MAX_PES} PEs, not a {cgra.rows}x{cgra.cols} "
                f"{cgra.topology}" + (" (heterogeneous)" if cgra.heterogeneous else "")
            )
        b = budget if budget is not None else SpaceBudget()
        stats = stats if stats is not None else SpaceStats()
        kw = dict(t_abs=t_abs, max_route_hops=max_route_hops, seed=seed,
                  should_stop=should_stop)
        window, r0, c0 = window_of(cgra)
        t0 = _time.perf_counter()
        wstats = SpaceStats()
        with obs.span("space.window", pes=window.num_pes, ii=ii) as sp:
            sol = self._exact.place(dfg, window, labels, ii, budget=b,
                                    stats=wstats, **kw)
            sp.set(outcome=wstats.outcome(
                sol is not None, should_stop is not None and should_stop()))
        _merge(stats, wstats)
        if sol is not None:
            stats.region = "window"

            def pe(p: int) -> int:
                r, c = divmod(p, window.cols)
                return (r + r0) * cgra.cols + c + c0

            return SpaceSolution(
                ii=sol.ii,
                placement=[pe(p) for p in sol.placement],
                routes=tuple(
                    MaterializedRoute(edge=r.edge, path=tuple(pe(p) for p in r.path),
                                      times=r.times)
                    for r in sol.routes),
            )
        stats.region = "fabric"
        rest = _rest(b, _time.perf_counter() - t0, wstats.nodes_visited)
        if rest is None:
            return None
        return self._anneal.place(dfg, cgra, labels, ii, budget=rest, stats=stats, **kw)


register_space_backend("window", WindowSpaceBackend)
