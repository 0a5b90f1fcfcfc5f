"""Process-pool batch compilation service (DESIGN.md §8).

Two axes of parallelism over the portfolio mapper (``core/mapper.py``):

* **Inter-job** — :func:`compile_many` maps many independent DFGs across a
  process pool (the search core is pure Python, so threads would serialise on
  the GIL). Each job carries its own per-job deadline; a shared stop event
  gives cooperative cancellation of in-flight work, and ``jobs<=1`` degrades
  to a fully in-process sequential run (used by deterministic CI smoke).
* **Intra-job** — :func:`map_dfg_racing` races ONE hard mapping problem by
  striping the canonical (II, slack) window order across workers
  (``window_offset``/``window_stride`` in ``map_dfg``). The first worker to
  finish with a mapping sets the stop event; the rest observe it at their
  next budget check and return their best-so-far (*first-winner
  cancellation*). The lowest II among the returned results wins.

Both layers reuse the round/budget logic of ``map_dfg`` unchanged — workers
run the ordinary portfolio search, just on a subset of windows — and both
share work across runs through the persistent disk cache (DESIGN.md §9).
"""

from __future__ import annotations

import os
import time as _time
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool
from dataclasses import dataclass, field
from typing import Sequence

from ... import obs
from ..cgra import CGRA
from ..dfg import DFG
from ..mapper import MapResult, map_dfg


def _as_mapper_kwargs(options) -> dict:
    """Normalise per-job/batch options: a plain kwarg dict passes through, a
    typed ``repro_torch.api.CompileOptions`` contributes its mapper fields.

    Duck-typed on ``mapper_kwargs`` rather than importing the api layer —
    ``repro_torch.api`` imports this module, so a type import would cycle.
    """
    if options is None:
        return {}
    if isinstance(options, dict):
        return dict(options)
    return options.mapper_kwargs()

# Worker-side stop event, installed by the pool initializer. Lives in a
# module global because multiprocessing primitives can only be inherited at
# process creation, not pickled per task.
_STOP_EVENT = None


def _pool_init(stop_event) -> None:
    global _STOP_EVENT
    _STOP_EVENT = stop_event


def _should_stop():
    ev = _STOP_EVENT
    return None if ev is None else ev.is_set


# ------------------------------------------------------------------- jobs

@dataclass
class CompileJob:
    """One unit of batch work: a DFG, a target CGRA, per-job overrides.

    ``options`` is forwarded to :func:`repro_torch.core.mapper.map_dfg` and wins
    over the batch-level defaults: either a kwarg dict (e.g.
    ``{"max_slack": 2, "max_register_pressure": 8}``) or a typed
    :class:`repro_torch.api.CompileOptions` (its mapper fields are used).
    """

    dfg: DFG
    cgra: CGRA
    name: str = ""
    options: dict = field(default_factory=dict)  # or repro_torch.api.CompileOptions

    def __post_init__(self) -> None:
        if not self.name:
            self.name = self.dfg.name


@dataclass
class JobReport:
    """Per-job outcome row of a :class:`CompileReport` (JSON-friendly).

    Carries the full mapper telemetry (phase timings, search trace) plus —
    when the job succeeded — the raw ``t_abs``/``placement`` arrays, so the
    API layer (``repro_torch.api.CompileResult.from_job_report``) can reconstruct
    the complete :class:`~repro_torch.core.mapper.Mapping` on the caller's side of
    the process boundary without re-solving.
    """

    name: str
    ok: bool
    ii: int | None
    m_ii: int
    wall_s: float
    cache_hit: bool = False
    disk_cache_hit: bool = False
    backend: str = ""
    space_backend: str = ""
    reason: str = ""
    cancelled: bool = False
    time_phase_s: float = 0.0
    space_phase_s: float = 0.0
    validate_s: float = 0.0
    mono_failures: int = 0
    res_ii: int = -1
    rec_ii: int = -1
    rounds: int = 0
    windows_opened: int = 0
    time_solutions_tried: int = 0
    space_nodes_visited: int = 0
    # solver/cache telemetry mirrored from MapperStats (DESIGN.md §15.3) so
    # the api layer builds an identical ``CompileResult.metrics`` block on
    # the caller's side of the process boundary
    time_steps: int = 0
    space_restarts: int = 0
    mem_cache_lookups: int = 0
    mem_cache_hits: int = 0
    disk_cache_lookups: int = 0
    disk_cache_hits: int = 0
    disk_cache_promotions: int = 0
    # the mapping itself (success only); excluded from as_dict row payloads.
    # ``routes`` is the route-through spec (src, dst, distance, n_movs) rows
    # needed to rebuild the rewritten DFG caller-side (DESIGN.md §12.2).
    t_abs: list[int] | None = None
    placement: list[int] | None = None
    routes: list[list[int]] | None = None

    @property
    def solved(self) -> bool:
        """True when the mapper actually searched (neither cache layer hit)."""
        return self.ok and not (self.cache_hit or self.disk_cache_hit)

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "ok": self.ok,
            "ii": self.ii,
            "mII": self.m_ii,
            "wall_s": round(self.wall_s, 4),
            "cache_hit": self.cache_hit,
            "disk_cache_hit": self.disk_cache_hit,
            "backend": self.backend,
            "space_backend": self.space_backend,
            "reason": self.reason,
            "cancelled": self.cancelled,
            "time_phase_s": round(self.time_phase_s, 4),
            "space_phase_s": round(self.space_phase_s, 4),
            "mono_failures": self.mono_failures,
        }


@dataclass
class CompileReport:
    """Batch outcome: per-job rows + aggregate cache/wall counters."""

    jobs: list[JobReport]
    wall_s: float
    num_workers: int

    @property
    def ok(self) -> bool:
        return all(j.ok for j in self.jobs)

    @property
    def cache_counters(self) -> dict:
        return {
            "memory_hits": sum(j.cache_hit for j in self.jobs),
            "disk_hits": sum(j.disk_cache_hit for j in self.jobs),
            "solved": sum(j.solved for j in self.jobs),
            "failed": sum(not j.ok for j in self.jobs),
        }

    def as_dict(self) -> dict:
        return {
            "wall_s": round(self.wall_s, 4),
            "num_workers": self.num_workers,
            "ok": self.ok,
            "cache": self.cache_counters,
            "jobs": [j.as_dict() for j in self.jobs],
        }


def _job_report(job: CompileJob, res: MapResult, wall_s: float) -> JobReport:
    return JobReport(
        name=job.name,
        ok=res.ok,
        ii=res.mapping.ii if res.ok else None,
        m_ii=res.stats.m_ii,
        wall_s=wall_s,
        cache_hit=res.stats.cache_hit,
        disk_cache_hit=res.stats.disk_cache_hit,
        backend=res.stats.backend,
        space_backend=res.stats.space_backend,
        reason=res.reason,
        time_phase_s=res.stats.time_phase_s,
        space_phase_s=res.stats.space_phase_s,
        validate_s=res.stats.validate_s,
        mono_failures=res.stats.mono_failures,
        res_ii=res.stats.res_ii,
        rec_ii=res.stats.rec_ii,
        rounds=res.stats.rounds,
        windows_opened=res.stats.windows_opened,
        time_solutions_tried=res.stats.time_solutions_tried,
        space_nodes_visited=res.stats.space_nodes_visited,
        time_steps=res.stats.time_steps,
        space_restarts=res.stats.space_restarts,
        mem_cache_lookups=res.stats.mem_cache_lookups,
        mem_cache_hits=res.stats.mem_cache_hits,
        disk_cache_lookups=res.stats.disk_cache_lookups,
        disk_cache_hits=res.stats.disk_cache_hits,
        disk_cache_promotions=res.stats.disk_cache_promotions,
        t_abs=list(res.mapping.t_abs) if res.ok else None,
        placement=list(res.mapping.placement) if res.ok else None,
        routes=[list(r) for r in res.mapping.routes_spec()] if res.ok else None,
    )


def _cancelled_report(job: CompileJob, reason: str) -> JobReport:
    return JobReport(
        name=job.name, ok=False, ii=None, m_ii=-1, wall_s=0.0,
        reason=reason, cancelled=True,
    )


def _run_job(job: CompileJob, defaults: dict, stop=None,
             trace_dir: str | None = None) -> JobReport:
    """Run one job and build its report; shared by the inline and pool paths.

    ``stop`` is a zero-arg cancellation predicate (or None). In pool workers
    it is derived from the inherited stop event (:func:`_run_job_pooled`); in
    the inline path it is the caller's ``cancel.is_set``.

    ``trace_dir``: when set and no tracer is already active in this process
    (the pool path), the job runs under a local tracer whose events are
    appended to a per-pid shard file and merged caller-side (DESIGN.md
    §15.2). With a tracer already active (the inline path) spans record into
    it directly and no shard is written.
    """
    active = obs.get_tracer()
    if trace_dir is not None and (active is None
                                  or active.pid != os.getpid()):
        # pool worker — note a forked child *inherits* the parent's tracer
        # object, but events recorded on that copy die with the process, so
        # detect it by pid and trace into a fresh local tracer persisted as
        # a per-pid shard instead
        tracer = obs.Tracer(process_name=f"repro-worker-{os.getpid()}")
        with obs.tracing(tracer):
            rep = _run_job(job, defaults, stop=stop)
        obs.append_shard(trace_dir, tracer.events, tracer.counters)
        return rep
    opts = {**defaults, **_as_mapper_kwargs(job.options)}
    if stop is not None:
        if stop():
            return _cancelled_report(job, "cancelled before start")
        opts.setdefault("should_stop", stop)
    t0 = _time.perf_counter()
    try:
        with obs.span("job", kernel=job.name) as sp:
            res = map_dfg(job.dfg, job.cgra, **opts)
            sp.set(ok=res.ok, ii=res.mapping.ii if res.ok else None)
    except Exception as exc:
        # any per-job failure (bad DFG, incompatible options, cache I/O)
        # fails its own row, never the batch
        return JobReport(name=job.name, ok=False, ii=None, m_ii=-1,
                         wall_s=_time.perf_counter() - t0,
                         reason=f"{type(exc).__name__}: {exc}")
    rep = _job_report(job, res, _time.perf_counter() - t0)
    if not res.ok and stop is not None and stop():
        rep.cancelled = True
        rep.reason = rep.reason or "cancelled"
    return rep


def _run_job_pooled(job: CompileJob, defaults: dict,
                    trace_dir: str | None = None) -> JobReport:
    """Top-level (picklable) pool entry: binds the inherited stop event."""
    return _run_job(job, defaults, stop=_should_stop(), trace_dir=trace_dir)


def compile_many(
    batch: Sequence[CompileJob],
    *,
    jobs: int | None = None,
    deadline_s: float | None = None,
    deterministic: bool = False,
    cache_dir: str | None = None,
    use_cache: bool = True,
    cancel=None,
    map_options: dict | None = None,
    trace_dir: str | None = None,
) -> CompileReport:
    """Compile a batch of DFGs concurrently across a process pool.

    Example — compile the Table III suite on a 5×5 CGRA with 4 workers and a
    warm persistent cache::

        from repro_torch.core import CGRA
        from repro_torch.core.benchsuite import load_suite
        from repro_torch.core.service import CompileJob, compile_many

        cgra = CGRA(5, 5)
        batch = [CompileJob(d, cgra) for d in load_suite().values()]
        report = compile_many(batch, jobs=4, cache_dir="/tmp/maps")
        assert report.ok
        # second run: every job is a disk/memory hit, no solving
        again = compile_many(batch, jobs=4, cache_dir="/tmp/maps")
        assert again.cache_counters["solved"] == 0

    Parameters:

    * ``jobs`` — worker processes (default ``os.cpu_count()``). ``jobs<=1``
      runs inline in this process: no pool, bit-identical to a hand loop —
      the mode CI's deterministic smoke exercises.
    * ``deadline_s`` — per-job wall budget, enforced *inside* the worker as
      the mapper's ``time_budget_s`` (a job that exceeds it returns its best
      mapping so far or a budget-exhausted failure; the pool is never killed).
      Ignored when ``deterministic`` (step budgets replace wall clocks).
    * ``deterministic`` — forward ``deterministic=True`` to every job: each
      job's result is then load- and schedule-independent, so the batch
      report is reproducible regardless of pool interleaving.
    * ``cache_dir`` — persistent mapping cache directory shared by all
      workers (DESIGN.md §9); defaults to ``$REPRO_CACHE_DIR`` when set.
    * ``cancel`` — optional ``threading.Event``-like object; once set, queued
      jobs are dropped and running jobs finish early at their next budget
      check, reported with ``cancelled=True``.
    * ``map_options`` — extra ``map_dfg`` kwargs applied to every job
      (overridden by each job's own ``options``): a dict, or a typed
      :class:`repro_torch.api.CompileOptions` whose mapper fields are forwarded.
    * ``trace_dir`` — span-shard directory for structured tracing (DESIGN.md
      §15.2): each pool worker appends its spans to ``shard-<pid>.jsonl``
      there; the caller merges the shards with :func:`repro_torch.obs.merge_shards`
      for a single cross-process timeline.
    """
    t0 = _time.perf_counter()
    defaults: dict = _as_mapper_kwargs(map_options)
    defaults.setdefault("use_cache", use_cache)
    defaults.setdefault("cache_dir", cache_dir)
    if deterministic:
        defaults.setdefault("deterministic", True)
    elif deadline_s is not None:
        defaults.setdefault("time_budget_s", deadline_s)

    num_workers = jobs if jobs is not None else (os.cpu_count() or 1)
    if num_workers <= 1 or len(batch) <= 1:
        stop = cancel.is_set if cancel is not None else None
        reports = [_run_job(job, defaults, stop=stop, trace_dir=trace_dir)
                   for job in batch]
        return CompileReport(reports, _time.perf_counter() - t0, 1)

    import multiprocessing as mp

    ctx = mp.get_context()
    stop_event = ctx.Event()
    reports_by_idx: dict[int, JobReport] = {}
    # Worker-loss recovery (DESIGN.md §8.1): an abruptly dead worker (OOM
    # kill, segfault in a C extension, os._exit) breaks the WHOLE executor —
    # every pending future raises BrokenProcessPool, including jobs that
    # never ran. Treat those jobs as *unfinished* rather than failed, respawn
    # the pool once and rerun them; a second break (the culprit job rides
    # along on the retry) fails whatever is still unfinished with a
    # machine-readable ``worker lost`` reason (failure code "worker-lost")
    # instead of wedging or over-failing the batch.
    remaining = set(range(len(batch)))
    respawns_left = 1
    while remaining:
        broken = False
        with ProcessPoolExecutor(
            max_workers=min(num_workers, len(remaining)),
            mp_context=ctx,
            initializer=_pool_init,
            initargs=(stop_event,),
        ) as pool:
            futures = {
                pool.submit(_run_job_pooled, batch[i], defaults, trace_dir): i
                for i in sorted(remaining)
            }
            pending = set(futures)
            # poll only when there is a cancel event to observe; block otherwise
            poll_s = 0.1 if cancel is not None else None
            while pending:
                done, pending = wait(pending, timeout=poll_s,
                                     return_when=FIRST_COMPLETED)
                for fut in done:
                    i = futures[fut]
                    if fut.cancelled():
                        reports_by_idx[i] = _cancelled_report(
                            batch[i], "cancelled before start")
                        remaining.discard(i)
                        continue
                    try:
                        reports_by_idx[i] = fut.result()
                        remaining.discard(i)
                    except BrokenProcessPool:
                        # unfinished, not failed: candidates for the respawn
                        broken = True
                    except Exception as exc:
                        # per-job failure crossing the boundary (pickling
                        # error, ...) fails this row, not the batch
                        reports_by_idx[i] = JobReport(
                            name=batch[i].name, ok=False, ii=None, m_ii=-1,
                            wall_s=0.0, reason=f"{type(exc).__name__}: {exc}")
                        remaining.discard(i)
                if broken:
                    break
                if (cancel is not None and cancel.is_set()
                        and not stop_event.is_set()):
                    stop_event.set()
                    for fut in list(pending):
                        if fut.cancel():
                            i = futures[fut]
                            reports_by_idx[i] = _cancelled_report(
                                batch[i], "cancelled before start")
                            remaining.discard(i)
                            pending.discard(fut)
        if broken:
            if respawns_left > 0:
                respawns_left -= 1
                continue
            for i in sorted(remaining):
                reports_by_idx[i] = JobReport(
                    name=batch[i].name, ok=False, ii=None, m_ii=-1,
                    wall_s=0.0,
                    reason="worker lost: process pool broken twice "
                           "(worker died mid-solve; pool respawned once)")
            remaining.clear()
    reports = [reports_by_idx[i] for i in range(len(batch))]
    return CompileReport(reports, _time.perf_counter() - t0,
                         min(num_workers, len(batch)))


# ----------------------------------------------------------- window racing

def _race_worker(dfg: DFG, cgra: CGRA, offset: int, stride: int,
                 options: dict) -> MapResult:
    opts = dict(options)
    stop = _should_stop()
    if stop is not None:
        opts.setdefault("should_stop", stop)
    res = map_dfg(dfg, cgra, window_offset=offset, window_stride=stride, **opts)
    if res.ok and _STOP_EVENT is not None:
        _STOP_EVENT.set()       # first winner: laggards wrap up at next check
    return res


def map_dfg_racing(
    dfg: DFG,
    cgra: CGRA,
    *,
    workers: int = 2,
    **options,
) -> MapResult:
    """Race one mapping problem's (II, slack) windows across processes.

    Worker ``i`` of ``w`` runs the ordinary portfolio search restricted to
    every ``w``-th window (``window_offset=i, window_stride=w``) of the
    canonical smallest-II-first order, so the workers partition the search
    space instead of duplicating it. The first worker that returns a mapping
    sets the shared stop event (*first-winner cancellation*); the others
    observe it at their next budget check and return early. The best
    (lowest-II) result wins — with ties broken toward the lowest offset so
    the choice is reproducible.

    ``workers`` is clamped to the window count (no worker gets an empty
    stripe); ``workers<=1`` after clamping, or ``deterministic=True`` (whose
    contract a wall-clock race cannot honor), falls back to plain
    :func:`~repro_torch.core.mapper.map_dfg`. Remaining keyword ``options`` are
    forwarded to ``map_dfg`` unchanged.

    When the space backend is left on ``auto`` and the fabric is large
    enough that auto resolves to ``anneal`` (DESIGN.md §13.3), the race
    additionally stripes *engines*: even-offset workers run the anneal
    favourite, odd-offset workers the exact engine. Whichever placement
    style fits the problem wins the race; small fabrics are unaffected.
    """
    from ..mapper import DEFAULT_MAX_SLACK, default_max_ii, ii_slack_windows
    from ..schedule import min_ii

    lo = min_ii(dfg, cgra)
    hi = options.get("max_ii") or default_max_ii(lo)
    n_windows = sum(
        1 for _ in ii_slack_windows(
            lo, hi, options.get("max_slack", DEFAULT_MAX_SLACK))
    )
    workers = min(workers, max(1, n_windows))
    if workers <= 1 or options.get("deterministic"):
        return map_dfg(dfg, cgra, **options)

    import multiprocessing as mp

    stripes = [options] * workers
    if options.get("space_backend", "auto") == "auto":
        from ..space_backends import resolve_space_backend_name

        if resolve_space_backend_name("auto", cgra) == "anneal":
            stripes = [
                {**options,
                 "space_backend": "anneal" if i % 2 == 0 else "exact"}
                for i in range(workers)
            ]

    t0 = _time.perf_counter()
    ctx = mp.get_context()
    stop_event = ctx.Event()
    with ProcessPoolExecutor(
        max_workers=workers,
        mp_context=ctx,
        initializer=_pool_init,
        initargs=(stop_event,),
    ) as pool:
        futs = [
            pool.submit(_race_worker, dfg, cgra, i, workers, stripes[i])
            for i in range(workers)
        ]
        results = [f.result() for f in futs]
    winners = [(r.mapping.ii, i) for i, r in enumerate(results) if r.ok]
    wall = _time.perf_counter() - t0
    if not winners:
        # deterministic pick among failures: the offset-0 stripe holds the
        # lowest-II windows, so its reason is the most informative
        res = results[0]
        res.stats.total_s = wall
        return res
    _, best_i = min(winners)
    res = results[best_i]
    res.stats.total_s = wall
    return res
