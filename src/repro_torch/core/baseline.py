"""Joint space-time mapping baseline (SAT-MapIt-style, paper ref [22]).

The comparison target for the paper's Table III / Fig. 5: a SAT/SMT encoding
over the *full* mapping space — boolean variables x[v, pe, t] over the KMS
window × PE grid, with

  * exactly-one position per node,
  * at-most-one node per (PE, kernel step)  [resource constraint],
  * support clauses per dependency edge: if u sits at (pu, tu) then v must sit
    at some time-compatible slot on a PE in pu's closed neighbourhood
    (register-file routing, same machine model as the decoupled mapper).

This is the standard "support" CNF encoding; it is faithful to the *joint*
search structure whose cost grows with |PEs| x II — exactly the scalability
wall the paper's decoupling removes. The II search loop (start at mII, widen
the window, then increment II) matches the decoupled mapper's, so compile-time
comparisons are apples-to-apples.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

from .cgra import CGRA
from .dfg import DFG
from .mapper import Mapping, MapResult, MapperStats, ii_slack_windows
from .schedule import asap_schedule, min_ii, modulo_windows, rec_ii, res_ii
from .time_backends.z3_backend import HAVE_Z3, z3


def map_dfg_joint(
    dfg: DFG,
    cgra: CGRA,
    *,
    max_ii: int | None = None,
    max_slack: int = 3,
    time_budget_s: float = 60.0,
) -> MapResult:
    """Joint mapper entry point; mirrors mapper.map_dfg's interface."""
    if not HAVE_Z3:
        raise RuntimeError("joint baseline requires z3")
    dfg.validate()
    stats = MapperStats(backend="z3-joint")
    if cgra.heterogeneous:
        # the joint encoding has no capability/port constraints; reject the
        # target gracefully instead of producing an invalid mapping
        return MapResult(
            None, stats,
            reason="joint baseline does not support heterogeneous targets "
                   "(capability classes / memory ports)",
        )
    stats.res_ii = res_ii(dfg, cgra)
    stats.rec_ii = rec_ii(dfg)
    stats.m_ii = min_ii(dfg, cgra)
    start = _time.perf_counter()
    deadline = start + time_budget_s
    hi = max_ii if max_ii is not None else max(stats.m_ii * 4, stats.m_ii + 8)

    # Same canonical window order as the decoupled mapper's portfolio, so
    # compile-time comparisons stay apples-to-apples; the joint encoding is
    # too monolithic to interleave budgets, which is exactly its problem.
    for ii, slack in ii_slack_windows(stats.m_ii, hi, max_slack):
        remaining = deadline - _time.perf_counter()
        if remaining <= 0:
            stats.total_s = _time.perf_counter() - start
            return MapResult(None, stats, reason="time budget exhausted")
        mapping = _solve_joint(dfg, cgra, ii, slack, remaining, stats)
        if mapping is not None:
            stats.final_ii = ii
            stats.total_s = _time.perf_counter() - start
            # registers=False: like the decoupled mapper, the joint encoding
            # does not constrain register pressure, only space-time validity
            errs = mapping.validate(registers=False)
            if errs:
                raise AssertionError(f"joint mapper invalid mapping: {errs}")
            return MapResult(mapping, stats)
    stats.total_s = _time.perf_counter() - start
    return MapResult(None, stats, reason=f"no mapping up to II={hi}")


def _solve_joint(
    dfg: DFG,
    cgra: CGRA,
    ii: int,
    slack: int,
    timeout_s: float,
    stats: MapperStats,
) -> Mapping | None:
    horizon = max(asap_schedule(dfg), default=0) + slack
    windows = modulo_windows(dfg, ii, horizon)
    if windows is None:
        return None
    asap, alap = windows
    d_m = cgra.connectivity_degree
    if any(len(n) > d_m * ii - 1 for n in dfg.undirected_adjacency()):
        return None  # analytic degree bound (same precheck as TimeSolver)
    num_pes = cgra.num_pes
    nbrs_closed = [(p, *cgra.neighbors[p]) for p in range(num_pes)]

    s = z3.Solver()
    s.set("timeout", max(1, int(timeout_s * 1000)))

    # x[v][(pe, t)] booleans over each node's KMS window x the PE grid
    x: list[dict[tuple[int, int], "z3.BoolRef"]] = []
    for v in dfg.nodes:
        xv = {
            (pe, t): z3.Bool(f"x_{v}_{pe}_{t}")
            for t in range(asap[v], alap[v] + 1)
            for pe in range(num_pes)
        }
        x.append(xv)
        s.add(z3.PbEq([(b, 1) for b in xv.values()], 1))  # exactly one

    # resource: at most one node per (pe, kernel step)
    by_pe_step: dict[tuple[int, int], list] = {}
    for v in dfg.nodes:
        for (pe, t), b in x[v].items():
            by_pe_step.setdefault((pe, t % ii), []).append(b)
    for lits in by_pe_step.values():
        if len(lits) > 1:
            s.add(z3.PbLe([(b, 1) for b in lits], 1))

    # dependencies: support clauses (u at (pu,tu)) -> v on a compatible slot
    for e in dfg.edges:
        tu_range = range(asap[e.src], alap[e.src] + 1)
        tv_range = range(asap[e.dst], alap[e.dst] + 1)
        for tu in tu_range:
            compat_ts = [tv for tv in tv_range if tv >= tu + 1 - ii * e.distance]
            for pu in range(num_pes):
                support = [
                    x[e.dst][(pv, tv)] for tv in compat_ts for pv in nbrs_closed[pu]
                ]
                s.add(z3.Implies(x[e.src][(pu, tu)], z3.Or(support)))

    t0 = _time.perf_counter()
    res = s.check()
    stats.time_phase_s += _time.perf_counter() - t0  # joint: all time is "search"
    if res != z3.sat:
        return None
    model = s.model()
    t_abs = [-1] * dfg.num_nodes
    placement = [-1] * dfg.num_nodes
    for v in dfg.nodes:
        for (pe, t), b in x[v].items():
            if z3.is_true(model.eval(b)):
                t_abs[v] = t
                placement[v] = pe
                break
    assert all(t >= 0 for t in t_abs)
    return Mapping(dfg=dfg, cgra=cgra, ii=ii, t_abs=t_abs, placement=placement)
