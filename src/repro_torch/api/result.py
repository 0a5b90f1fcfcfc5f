"""Structured compile outcomes: :class:`CompileResult` / :class:`BatchResult`.

One result schema unifies what used to diverge between the mapper's
``MapResult`` and the service's ``JobReport``/``CompileReport`` (DESIGN.md
§11.3): per-phase timings (time search, space search, validation), the
window/backoff trace, cache provenance, and a *machine-readable* failure
code next to the human-readable reason. ``CompileResult.as_dict()`` is the
canonical row serialisation — the CLI JSON report, the benchmark artifacts,
and service rows all emit exactly this shape.

Failure codes (:data:`FAILURE_KINDS`):

* ``infeasible`` — structurally impossible (an op class with no capable PE);
* ``budget-exhausted`` — the wall/step budget ran out before a mapping;
* ``search-exhausted`` — the whole (II, slack) space was proven empty;
* ``cancelled`` — cooperative cancellation (service stop event, or a
  daemon request whose deadline expired while still queued);
* ``overloaded`` — shed by daemon admission control before any solving
  (queue full / deadline budget exceeded, DESIGN.md §16.2) — the caller
  should back off and retry;
* ``worker-lost`` — a pool worker died mid-solve and the job could not be
  recovered after the one pool respawn (DESIGN.md §8.1);
* ``error`` — the compile raised (bad DFG, worker death, cache I/O);
* ``unknown`` — anything the classifier cannot attribute.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # imported lazily at runtime to keep this module cheap
    from ..core.cgra import CGRA
    from ..core.dfg import DFG
    from ..core.mapper import Mapping, MapResult
    from ..core.service.batch import CompileReport, JobReport

__all__ = [
    "BatchResult",
    "CompileResult",
    "FAILURE_KINDS",
    "PhaseTimings",
    "SearchTrace",
    "build_metrics",
    "classify_failure",
]

FAILURE_KINDS = (
    "infeasible",
    "budget-exhausted",
    "search-exhausted",
    "cancelled",
    "overloaded",
    "worker-lost",
    "error",
    "unknown",
)

# exception rows are formatted f"{type(exc).__name__}: {exc}" by the service
# layer; every mapper-produced reason starts lowercase, so an uppercase-
# leading identifier + colon is unambiguous (covers BrokenProcessPool,
# TimeoutError, KeyboardInterrupt, custom exception names alike)
_EXC_REASON_RE = re.compile(r"^[A-Z][A-Za-z0-9_]*: ")


def classify_failure(ok: bool, reason: str, cancelled: bool = False) -> str | None:
    """Map a human-readable failure reason to a machine-readable code.

    Returns None for successful compiles. The classifier is anchored on the
    reason strings the mapper/service actually produce (``core/mapper.py``
    ``finish()``/capability fail-fast, ``core/service/batch.py`` error rows);
    anything unrecognised lands in ``unknown`` rather than raising.
    """
    if ok:
        return None
    if cancelled:
        return "cancelled"
    r = reason or ""
    if r.startswith("overloaded"):
        return "overloaded"
    if r.startswith("worker lost"):
        return "worker-lost"
    if r.startswith("infeasible"):
        return "infeasible"
    if "search space exhausted" in r:
        return "search-exhausted"
    if "budget exhausted" in r or "within budget" in r:
        return "budget-exhausted"
    if "cancelled" in r:
        return "cancelled"
    if _EXC_REASON_RE.match(r):
        return "error"
    return "unknown"


@dataclass(frozen=True)
class PhaseTimings:
    """Wall seconds per pipeline phase (DESIGN.md §1 stages + validation)."""

    time_s: float = 0.0        # TIME: modulo-schedule search
    space_s: float = 0.0       # SPACE: monomorphism search
    validate_s: float = 0.0    # independent re-validation of candidate/served mappings
    exact_s: float = 0.0       # exact-check certification post-pass (§14)
    total_s: float = 0.0       # whole compile() call (incl. exact_s when run)

    def as_dict(self) -> dict:
        return {
            "time_s": round(self.time_s, 6),
            "space_s": round(self.space_s, 6),
            "validate_s": round(self.validate_s, 6),
            "exact_s": round(self.exact_s, 6),
            "total_s": round(self.total_s, 6),
        }


@dataclass(frozen=True)
class SearchTrace:
    """Window/backoff trace of the portfolio search (DESIGN.md §6)."""

    rounds: int = 0                 # portfolio rounds entered
    windows_opened: int = 0         # (II, slack) windows that got a time solver
    time_solutions_tried: int = 0   # label partitions proposed by TIME
    mono_failures: int = 0          # partitions SPACE failed to embed (backoffs)
    space_nodes_visited: int = 0    # monomorphism search nodes

    def as_dict(self) -> dict:
        return {
            "rounds": self.rounds,
            "windows_opened": self.windows_opened,
            "time_solutions_tried": self.time_solutions_tried,
            "mono_failures": self.mono_failures,
            "space_nodes_visited": self.space_nodes_visited,
        }


def _hit_rate(hits: int, lookups: int) -> float | None:
    return round(hits / lookups, 6) if lookups else None


def build_metrics(
    *,
    trace: "SearchTrace",
    phases: "PhaseTimings",
    time_steps: int = 0,
    space_restarts: int = 0,
    mem_lookups: int = 0,
    mem_hits: int = 0,
    disk_lookups: int = 0,
    disk_hits: int = 0,
    disk_promotions: int = 0,
) -> dict:
    """The aggregated per-row ``metrics`` block (DESIGN.md §15.3).

    One builder serves every frontend: ``from_map_result`` (CLI/bench
    in-process rows) and ``from_job_report`` (service rows) both call it
    with counters their respective stats objects carry, so the schema
    cannot diverge between outputs. ``hit_rate`` is None when the layer
    was never consulted (``use_cache=False`` / deterministic runs).
    """
    return {
        "solver": {
            "rounds": trace.rounds,
            "windows_opened": trace.windows_opened,
            "time_solutions_tried": trace.time_solutions_tried,
            "time_steps": time_steps,
            "mono_failures": trace.mono_failures,
            "space_nodes_visited": trace.space_nodes_visited,
            "space_restarts": space_restarts,
        },
        "cache": {
            "memory": {
                "lookups": mem_lookups,
                "hits": mem_hits,
                "hit_rate": _hit_rate(mem_hits, mem_lookups),
            },
            "disk": {
                "lookups": disk_lookups,
                "hits": disk_hits,
                "promotions": disk_promotions,
                "hit_rate": _hit_rate(disk_hits, disk_lookups),
            },
        },
        "phases": phases.as_dict(),
    }


@dataclass
class CompileResult:
    """One compile outcome in the unified schema (DESIGN.md §11.3).

    Example — compile and read the structured telemetry::

        from repro_torch.api import Compiler, resolve_options
        from repro_torch.core import CGRA, running_example

        comp = Compiler(CGRA(2, 2), resolve_options("deterministic-ci"))
        res = comp.compile(running_example())
        assert res.ok and res.ii == 4 and res.source == "solve"
        row = res.as_dict()          # the exact JSON row every frontend emits
        assert row["phases"]["time_s"] >= 0 and row["failure"] is None

    ``mapping`` is the full space-time mapping when available (always for
    in-process compiles; reconstructed from the worker's row for batch
    compiles), or None on failure.
    """

    name: str
    ok: bool
    ii: int | None = None
    m_ii: int = -1
    res_ii: int = -1
    rec_ii: int = -1
    backend: str = ""
    #: space (placement) engine that produced the mapping ("" when failed)
    space_backend: str = ""
    #: cache provenance: "memory" | "disk" | "solve" (None when failed)
    source: str | None = None
    wall_s: float = 0.0
    phases: PhaseTimings = field(default_factory=PhaseTimings)
    trace: SearchTrace = field(default_factory=SearchTrace)
    #: machine-readable failure code (see FAILURE_KINDS); None when ok
    failure: str | None = None
    reason: str = ""
    cancelled: bool = False
    #: route-through movs spliced into the mapping (0 = direct embedding)
    route_movs: int = 0
    #: optional ``simulate.utilization_report`` block (opt-in, see compile CLI)
    utilization: dict | None = None
    #: optional daemon/service provenance block (DESIGN.md §16.4): tenant,
    #: deadline, queue wait, coalescing and speculative-warm attribution —
    #: set only by the compile daemon, absent from in-process rows
    service: dict | None = None
    #: certified optimal II (exact-check runs; None = not proven / not run)
    ii_opt: int | None = None
    #: optimality certificate dict (``exact_backends.Certificate.as_dict``,
    #: DESIGN.md §14) — present only when the compile ran with exact_check
    certificate: dict | None = None
    #: aggregated observability block (:func:`build_metrics`, DESIGN.md §15.3):
    #: solver counters, both cache layers' hit rates, per-phase rollups —
    #: always emitted with an identical schema in CLI, bench, and service rows
    metrics: dict = field(default_factory=dict)
    mapping: "Mapping | None" = None

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_map_result(
        cls, res: "MapResult", *, name: str = "", wall_s: float | None = None
    ) -> "CompileResult":
        """Lift a mapper ``MapResult`` into the unified schema."""
        s = res.stats
        if res.ok:
            source = ("memory" if s.cache_hit
                      else "disk" if s.disk_cache_hit else "solve")
        else:
            source = None
        phases = PhaseTimings(
            time_s=s.time_phase_s,
            space_s=s.space_phase_s,
            validate_s=s.validate_s,
            total_s=s.total_s,
        )
        trace = SearchTrace(
            rounds=s.rounds,
            windows_opened=s.windows_opened,
            time_solutions_tried=s.time_solutions_tried,
            mono_failures=s.mono_failures,
            space_nodes_visited=s.space_nodes_visited,
        )
        return cls(
            name=name or (res.mapping.dfg.name if res.ok else name),
            ok=res.ok,
            ii=res.mapping.ii if res.ok else None,
            m_ii=s.m_ii,
            res_ii=s.res_ii,
            rec_ii=s.rec_ii,
            backend=s.backend,
            space_backend=s.space_backend,
            source=source,
            wall_s=wall_s if wall_s is not None else s.total_s,
            phases=phases,
            trace=trace,
            failure=classify_failure(res.ok, res.reason),
            reason=res.reason,
            route_movs=res.mapping.num_route_movs if res.ok else 0,
            metrics=build_metrics(
                trace=trace,
                phases=phases,
                time_steps=s.time_steps,
                space_restarts=s.space_restarts,
                mem_lookups=s.mem_cache_lookups,
                mem_hits=s.mem_cache_hits,
                disk_lookups=s.disk_cache_lookups,
                disk_hits=s.disk_cache_hits,
                disk_promotions=s.disk_cache_promotions,
            ),
            mapping=res.mapping,
        )

    @classmethod
    def from_job_report(
        cls, job: "JobReport", dfg: "DFG | None" = None,
        cgra: "CGRA | None" = None, *,
        max_register_pressure: int | None = None,
    ) -> "CompileResult":
        """Lift a service row; reconstructs the Mapping when the worker
        shipped ``t_abs``/``placement`` (plus any route-through spec) back
        and the caller provides the (unpickled-once) DFG/CGRA pair.

        Reconstructed mappings are re-validated on the caller's side with
        the same checks the direct path runs — structure always, and the
        per-PE register guarantee (``min(max_register_pressure,
        registers_at(pe))``) whenever the batch requested one — so a stale
        worker cache or a version-skewed worker can never make the batch
        path accept what ``Compiler.compile`` would reject. A row failing
        re-validation is flipped to a failure (``failure == "error"``)."""
        mapping = None
        if (job.ok and dfg is not None and cgra is not None
                and job.t_abs is not None and job.placement is not None
                and job.ii is not None):
            from ..core.dfg import splice_routes
            from ..core.mapper import Mapping, _pressure_offenders

            try:
                routes = []
                if job.routes:
                    dfg, routes = splice_routes(
                        dfg, [tuple(r) for r in job.routes]
                    )
                mapping = Mapping(dfg=dfg, cgra=cgra, ii=job.ii,
                                  t_abs=list(job.t_abs),
                                  placement=list(job.placement),
                                  routes=routes)
                errs = mapping.validate(registers=False)
                if not errs and max_register_pressure is not None:
                    errs = [
                        f"register pressure over effective bound on PE {pe}"
                        for pe in _pressure_offenders(
                            mapping, max_register_pressure)
                    ]
            except (ValueError, IndexError) as exc:
                errs = [f"malformed worker mapping: {exc}"]
            if errs:
                job = dataclasses.replace(
                    job, ok=False, ii=None, t_abs=None, placement=None,
                    routes=None,
                    reason="ValidationError: worker mapping rejected "
                           f"caller-side: {'; '.join(errs)}",
                )
                mapping = None
        if job.ok:
            source = ("memory" if job.cache_hit
                      else "disk" if job.disk_cache_hit else "solve")
        else:
            source = None
        phases = PhaseTimings(
            time_s=job.time_phase_s,
            space_s=job.space_phase_s,
            validate_s=job.validate_s,
            total_s=job.wall_s,
        )
        trace = SearchTrace(
            rounds=job.rounds,
            windows_opened=job.windows_opened,
            time_solutions_tried=job.time_solutions_tried,
            mono_failures=job.mono_failures,
            space_nodes_visited=job.space_nodes_visited,
        )
        return cls(
            name=job.name,
            ok=job.ok,
            ii=job.ii,
            m_ii=job.m_ii,
            res_ii=job.res_ii,
            rec_ii=job.rec_ii,
            backend=job.backend,
            space_backend=job.space_backend,
            source=source,
            wall_s=job.wall_s,
            phases=phases,
            trace=trace,
            failure=classify_failure(job.ok, job.reason, job.cancelled),
            reason=job.reason,
            cancelled=job.cancelled,
            route_movs=mapping.num_route_movs if mapping is not None else 0,
            metrics=build_metrics(
                trace=trace,
                phases=phases,
                time_steps=job.time_steps,
                space_restarts=job.space_restarts,
                mem_lookups=job.mem_cache_lookups,
                mem_hits=job.mem_cache_hits,
                disk_lookups=job.disk_cache_lookups,
                disk_hits=job.disk_cache_hits,
                disk_promotions=job.disk_cache_promotions,
            ),
            mapping=mapping,
        )

    # -------------------------------------------------------------------- I/O
    def as_dict(self) -> dict:
        """The canonical JSON row (CLI report, benchmarks, service rows).

        The ``utilization`` key is opt-in (only present when the block was
        computed, e.g. ``repro_torch.compile --report-utilization``) so existing
        row consumers keep seeing the exact historical shape by default.
        """
        row = {
            "name": self.name,
            "ok": self.ok,
            "ii": self.ii,
            "mII": self.m_ii,
            "resII": self.res_ii,
            "recII": self.rec_ii,
            "backend": self.backend,
            "space_backend": self.space_backend,
            "source": self.source,
            "wall_s": round(self.wall_s, 6),
            "phases": self.phases.as_dict(),
            "trace": self.trace.as_dict(),
            "failure": self.failure,
            "reason": self.reason,
            "cancelled": self.cancelled,
            "route_movs": self.route_movs,
            "metrics": self.metrics or build_metrics(
                trace=self.trace, phases=self.phases),
        }
        if self.utilization is not None:
            row["utilization"] = self.utilization
        if self.service is not None:
            # daemon rows only (DESIGN.md §16.4): tenant/deadline/queue/
            # coalescing provenance; plain compiles keep the historical shape
            row["service"] = self.service
        if self.certificate is not None:
            # exact-check rows (DESIGN.md §14.4): the certified-optimal II
            # (None while status is "timeout") next to the full certificate
            row["ii_opt"] = self.ii_opt
            row["certificate"] = self.certificate
        return row


@dataclass
class BatchResult:
    """A batch of :class:`CompileResult` rows + aggregate counters."""

    results: list[CompileResult]
    wall_s: float = 0.0
    num_workers: int = 1

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    @property
    def cache_counters(self) -> dict:
        """Aggregate provenance counters (memory/disk/solved/failed)."""
        return {
            "memory_hits": sum(r.source == "memory" for r in self.results),
            "disk_hits": sum(r.source == "disk" for r in self.results),
            "solved": sum(r.source == "solve" for r in self.results),
            "failed": sum(not r.ok for r in self.results),
        }

    @property
    def metrics(self) -> dict:
        """Batch-level rollup of the per-row metrics blocks (§15.3):
        summed solver counters and both cache layers' aggregate hit rates
        (the ROADMAP compile-daemon "hit-rate telemetry" numbers)."""
        rows = [r.metrics for r in self.results if r.metrics]
        solver: dict[str, int] = {}
        cache = {
            "memory": {"lookups": 0, "hits": 0},
            "disk": {"lookups": 0, "hits": 0, "promotions": 0},
        }
        for m in rows:
            for k, v in m.get("solver", {}).items():
                solver[k] = solver.get(k, 0) + v
            for layer, counters in cache.items():
                src = m.get("cache", {}).get(layer, {})
                for k in counters:
                    counters[k] += src.get(k, 0) or 0
        for layer, counters in cache.items():
            counters["hit_rate"] = _hit_rate(
                counters["hits"], counters["lookups"])
        return {"solver": solver, "cache": cache}

    def __iter__(self):
        return iter(self.results)

    def __len__(self) -> int:
        return len(self.results)

    @classmethod
    def from_report(
        cls, report: "CompileReport", pairs=None, *,
        max_register_pressure: int | None = None,
    ) -> "BatchResult":
        """Lift a service ``CompileReport``; ``pairs`` is the matching list
        of (dfg, cgra) used to reconstruct mappings from worker rows, and
        ``max_register_pressure`` the batch's per-PE pressure guarantee
        (rows failing caller-side re-validation become failures)."""
        pairs = pairs or [(None, None)] * len(report.jobs)
        return cls(
            results=[
                CompileResult.from_job_report(
                    j, dfg, cgra,
                    max_register_pressure=max_register_pressure,
                )
                for j, (dfg, cgra) in zip(report.jobs, pairs)
            ],
            wall_s=report.wall_s,
            num_workers=report.num_workers,
        )

    def as_dict(self) -> dict:
        return {
            "ok": self.ok,
            "wall_s": round(self.wall_s, 4),
            "num_workers": self.num_workers,
            "cache": self.cache_counters,
            "metrics": self.metrics,
            "jobs": [r.as_dict() for r in self.results],
        }
