"""The persistent compile daemon: :class:`CompileDaemon` (DESIGN.md §16).

A long-running, in-process compile server layered on the existing pieces —
the :class:`repro_torch.api.Compiler` session, the two-layer mapping cache
(DESIGN.md §9) and the cooperative-cancellation hooks of the portfolio
mapper — so the *warm* path of a request is a memory-cache hit plus queue
bookkeeping (sub-millisecond), while the cold path pays the ordinary solve
once per (dfg, options) key for the life of the cache.

Request lifecycle::

    submit() ── admission ──> queue ──> worker thread ──> CompileResult row
         │          │                      │
         │          ├─ shed: failure="overloaded" (queue full / no
         │          │        deadline budget) — never queued, never solved
         │          └─ coalesce: identical in-flight (dfg, options) request
         │                       → attach as follower, share the one solve
         └─ Ticket.wait() → the unified CompileResult row dict

* **Admission control** — a bounded queue (``queue_limit``) plus a deadline
  budget check: a request whose own deadline is shorter than the estimated
  queue wait (EWMA of recent service times × queue depth / workers) is shed
  immediately with the machine-readable ``overloaded`` failure code rather
  than admitted to time out. Shedding never raises and never blocks.
* **Per-tenant deadlines** — each request carries ``deadline_s`` (and a
  ``tenant`` label for attribution); the remaining budget at pickup becomes
  the mapper's ``time_budget_s`` and the request's ``should_stop`` hook, so
  a deadline expiring mid-solve cancels cooperatively inside the worker. A
  request whose deadline expired while still queued finishes as
  ``cancelled`` without occupying a worker.
* **Coalescing** — concurrent identical (dfg, arch, mapper-options) requests
  share one solve: the first becomes the leader, later ones attach as
  followers and receive a copy of the leader's row (``service.coalesced``)
  the moment it finishes. This closes the cold-cache stampede window that
  per-request caching alone cannot (N concurrent misses → N solves).
* **Speculative premapping** — a background thread that runs only while the
  queue is empty and all workers are idle, warming both cache layers for
  *neighboring* option variants (±1 ``max_route_hops``, relaxed register
  pressure) of recently requested kernels. Warmed keys are remembered; a
  later real request served from a speculatively warmed key is attributed
  ``speculative`` provenance in ``metrics.cache`` and the daemon's
  ``speculative_hits`` counter, so the policy's payoff is measurable
  (``benchmarks/bench_service.py`` gates it in CI).

Workers are *threads*, not processes: the warm path (cache hit) never
touches the GIL-bound solver, and cold solves inherit the process-wide
memory LRU + disk cache directly. The solver itself is pure Python, so
concurrent cold solves time-slice; daemons fronting heavy cold traffic
should pre-warm via ``repro_torch.compile`` / speculation (DESIGN.md §16.6).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time as _time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

from ... import obs
from ...api import CompileOptions, Compiler, CompileResult
from ...api.result import classify_failure
from ..dfg import DFG
from ..mapper import _cache_base_key
from ..space_backends import resolve_space_backend_name

__all__ = ["CompileDaemon", "DaemonStats", "Ticket", "neighbor_options"]

#: How many recently completed request keys feed the speculator.
_RECENT_LIMIT = 64
#: Default cap on remembered speculative-attempt keys (dedup, bounded).
_ATTEMPT_LIMIT = 4096


@dataclass
class DaemonStats:
    """Daemon-lifetime counters (all guarded by the daemon lock)."""

    submitted: int = 0
    completed: int = 0
    shed: int = 0
    coalesced: int = 0
    cancelled_in_queue: int = 0
    solves: int = 0
    warm_memory: int = 0
    warm_disk: int = 0
    failed: int = 0
    speculative_attempts: int = 0
    speculative_warms: int = 0
    speculative_hits: int = 0
    cache_prunes: int = 0
    cache_evictions: int = 0

    def as_dict(self) -> dict:
        warm = self.warm_memory + self.warm_disk
        done = self.completed
        return {
            "submitted": self.submitted,
            "completed": done,
            "shed": self.shed,
            "coalesced": self.coalesced,
            "cancelled_in_queue": self.cancelled_in_queue,
            "solves": self.solves,
            "warm_memory": self.warm_memory,
            "warm_disk": self.warm_disk,
            "failed": self.failed,
            "warm_hit_rate": round(warm / done, 6) if done else None,
            "speculative": {
                "attempts": self.speculative_attempts,
                "warms": self.speculative_warms,
                "hits": self.speculative_hits,
                "hit_rate": round(self.speculative_hits / done, 6)
                            if done else None,
            },
            "cache_maintenance": {
                "prunes": self.cache_prunes,
                "evictions": self.cache_evictions,
            },
        }


class _Request:
    """One admitted compile request (leader or follower)."""

    __slots__ = ("rid", "dfg", "opts", "tenant", "deadline_s", "t_submit",
                 "done", "row", "followers", "key")

    def __init__(self, rid, dfg, opts, tenant, deadline_s, key):
        self.rid = rid
        self.dfg = dfg
        self.opts = opts
        self.tenant = tenant
        self.deadline_s = deadline_s
        self.t_submit = _time.perf_counter()
        self.done = threading.Event()
        self.row: dict | None = None
        self.followers: list[_Request] = []
        self.key = key

    def expired(self, now: float | None = None) -> bool:
        if self.deadline_s is None:
            return False
        return (now or _time.perf_counter()) - self.t_submit > self.deadline_s


class Ticket:
    """Caller handle for a submitted request: ``wait()`` → the result row.

    Shed requests return a completed ticket immediately (the overloaded row
    is already attached), so callers never need to special-case admission.
    """

    __slots__ = ("_req",)

    def __init__(self, req: _Request):
        self._req = req

    @property
    def done(self) -> bool:
        return self._req.done.is_set()

    def wait(self, timeout: float | None = None) -> dict | None:
        """Block for the CompileResult row dict (None on wait timeout)."""
        if not self._req.done.wait(timeout):
            return None
        return self._req.row


def neighbor_options(opts: CompileOptions) -> list[CompileOptions]:
    """The speculative-premap variant set of one request's options.

    Neighbors along the cache-key axes a *single-target* daemon can vary
    (DESIGN.md §16.3): the route-through hop allowance ±1 (clamped at 0) and
    the relaxed register-pressure variant (``max_register_pressure=None``)
    when the request constrained it. The arch axis is fixed per daemon — a
    daemon serves one machine, so arch neighbors would warm keys no request
    of this daemon can ever ask for.
    """
    variants: list[CompileOptions] = []
    h = opts.max_route_hops
    for nh in (h + 1, h - 1):
        if nh >= 0:
            variants.append(opts.replace(max_route_hops=nh))
    if opts.max_register_pressure is not None:
        variants.append(opts.replace(max_register_pressure=None))
    return variants


class CompileDaemon:
    """Persistent compile server over one :class:`~repro_torch.api.Compiler`.

    Example — an in-process daemon session::

        from repro_torch.core.daemon import CompileDaemon
        from repro_torch.core import CGRA, running_example

        daemon = CompileDaemon(CGRA(4, 4), "fast", workers=2)
        daemon.start()
        try:
            row = daemon.submit(running_example(), tenant="t0").wait()
            assert row["ok"] and row["service"]["tenant"] == "t0"
        finally:
            daemon.stop()

    Parameters:

    * ``target`` / ``options`` — forwarded to :class:`repro_torch.api.Compiler`
      (CGRA / ArchSpec / preset string; CompileOptions / profile name).
    * ``workers`` — compile worker threads.
    * ``queue_limit`` — max *queued* (not in-flight) requests before
      admission control sheds with ``overloaded``.
    * ``speculate`` — enable idle-time speculative premapping (forced off in
      deterministic sessions, whose mapper bypasses both caches, and when
      ``use_cache`` is off — there is nothing to warm).
    * ``speculate_budget_s`` — wall budget per speculative warm compile.
    * ``cache_max_bytes`` / ``cache_max_age_s`` — periodic
      :meth:`DiskMappingCache.prune` bounds so a long-running daemon's disk
      cache cannot grow without bound.
    * ``trace_dir`` — when set, the daemon installs a session tracer and
      rotates drained span segments into ``trace-<seq>.json`` files there
      (every ``rotate_every`` completed requests and at shutdown); each
      segment is a standalone Perfetto/``tools/trace_report.py`` document.
    """

    def __init__(
        self,
        target=None,
        options=None,
        *,
        workers: int = 2,
        queue_limit: int = 64,
        speculate: bool = True,
        speculate_budget_s: float = 10.0,
        cache_max_bytes: int | None = None,
        cache_max_age_s: float | None = None,
        prune_every: int = 64,
        trace_dir: str | None = None,
        rotate_every: int = 256,
        **overrides,
    ) -> None:
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.compiler = Compiler(target, options, **overrides)
        self.options = self.compiler.options
        self.num_workers = workers
        self.queue_limit = queue_limit
        self.speculate = (speculate and self.options.use_cache
                          and not self.options.deterministic)
        self.speculate_budget_s = speculate_budget_s
        self.cache_max_bytes = cache_max_bytes
        self.cache_max_age_s = cache_max_age_s
        self.prune_every = max(1, prune_every)
        self.trace_dir = trace_dir
        self.rotate_every = max(1, rotate_every)
        self.stats = DaemonStats()

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque[_Request] = deque()
        self._inflight: dict[str, _Request] = {}   # key -> leader
        self._active = 0                           # workers mid-request
        self._rid = itertools.count(1)
        self._ewma_service_s = 0.0                 # admission wait estimate
        self._started = False
        self._stopping = False
        self._threads: list[threading.Thread] = []
        # speculation state: FIFO of pending (dfg, variant-opts), bounded
        # dedup of attempted variant keys, and the warmed-key set that
        # attributes later real hits to speculation
        self._spec_pending: deque[tuple[DFG, CompileOptions]] = deque()
        self._spec_attempted: OrderedDict[tuple, None] = OrderedDict()
        self._spec_keys: set[tuple] = set()
        self._since_prune = 0
        # trace rotation
        self._tracer: obs.Tracer | None = None
        self._tracer_prev: obs.Tracer | None = None
        self._rotate_seq = 0
        self._since_rotate = 0

    # ---------------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Spawn the worker (and speculator) threads; idempotent."""
        with self._lock:
            if self._started:
                return
            self._started = True
        if self.trace_dir is not None:
            os.makedirs(self.trace_dir, exist_ok=True)
            self._tracer = obs.Tracer(process_name="repro-daemon")
            self._tracer_prev = obs.install_tracer(self._tracer)
        for i in range(self.num_workers):
            t = threading.Thread(target=self._worker_loop,
                                 name=f"repro-daemon-worker-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        if self.speculate:
            t = threading.Thread(target=self._speculator_loop,
                                 name="repro-daemon-speculator", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self, timeout: float = 10.0) -> None:
        """Drain nothing, stop everything: queued requests finish as
        ``cancelled``, in-flight compiles observe ``should_stop`` at their
        next budget check, threads join, the trace session rotates out."""
        with self._cv:
            self._stopping = True
            queued = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        for req in queued:
            self._finish(req, self._failure_row(
                req, "cancelled: daemon stopped", cancelled=True))
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads.clear()
        if self._tracer is not None:
            self._rotate(force=True)
            obs.install_tracer(self._tracer_prev)
            self._tracer = None

    def __enter__(self) -> "CompileDaemon":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ submit
    def submit(
        self,
        dfg: DFG,
        *,
        tenant: str | None = None,
        deadline_s: float | None = None,
        **overrides,
    ) -> Ticket:
        """Admit one compile request; returns immediately with a Ticket.

        ``deadline_s`` defaults to the session's ``options.deadline_s``
        (None = no deadline); ``tenant`` defaults to ``options.tenant``.
        ``**overrides`` are per-request option changes (e.g.
        ``max_route_hops=1``) resolved against the session options — the
        same override semantics every other frontend uses.
        """
        opts = self.compiler.options
        if overrides:
            opts = opts.replace(**overrides)
            opts.validate()
        tenant = tenant if tenant is not None else opts.tenant
        deadline_s = deadline_s if deadline_s is not None else opts.deadline_s
        key = self._coalesce_key(dfg, opts)
        req = _Request(next(self._rid), dfg, opts, tenant, deadline_s, key)
        with self._cv:
            self.stats.submitted += 1
            if self._stopping or not self._started:
                if self._stopping:
                    self.stats.shed += 1
                    self._set_row(req, self._failure_row(
                        req, "overloaded: daemon is shutting down"))
                    return Ticket(req)
                # not started yet: queue freely (tests drive this mode —
                # requests admitted now run when start() is called)
            leader = self._inflight.get(key)
            if leader is not None:
                # stampede coalescing: ride the in-flight identical request
                leader.followers.append(req)
                self.stats.coalesced += 1
                return Ticket(req)
            shed_reason = self._admission_reason(req)
            if shed_reason is not None:
                self.stats.shed += 1
                obs.event("daemon.shed", kernel=dfg.name, tenant=tenant)
                self._set_row(req, self._failure_row(req, shed_reason))
                return Ticket(req)
            self._inflight[key] = req
            self._queue.append(req)
            self._cv.notify()
        return Ticket(req)

    def compile(self, dfg: DFG, **kwargs) -> dict:
        """Synchronous convenience: ``submit(...).wait()``."""
        return self.submit(dfg, **kwargs).wait()

    # ----------------------------------------------------------------- queries
    def stats_dict(self) -> dict:
        with self._lock:
            d = self.stats.as_dict()
            d["queue_depth"] = len(self._queue)
            d["active"] = self._active
            d["workers"] = self.num_workers
            d["queue_limit"] = self.queue_limit
            d["speculate"] = self.speculate
            d["ewma_service_s"] = round(self._ewma_service_s, 6)
        cache = self.compiler.cache
        if cache is not None:
            d["disk_cache"] = cache.stats.as_dict()
        return d

    # ---------------------------------------------------------------- internals
    def _coalesce_key(self, dfg: DFG, opts: CompileOptions) -> str:
        """Identity of "the same solve": DFG content + every mapper-visible
        option. Tenant/deadline deliberately excluded — they shape *service*,
        not the mapping, so requests differing only there coalesce."""
        kw = opts.mapper_kwargs()
        kw["exact_check"] = opts.exact_check
        return dfg.stable_hash() + "|" + json.dumps(
            kw, sort_keys=True, default=str)

    def _cache_key(self, dfg: DFG, opts: CompileOptions) -> tuple:
        """The mapping-cache base key this request resolves to (§9/§13.4) —
        the unit of speculative-warm attribution."""
        return _cache_base_key(
            dfg, self.compiler.cgra, opts.connectivity,
            opts.max_register_pressure, opts.max_route_hops,
            resolve_space_backend_name(opts.space_backend, self.compiler.cgra),
        )

    def _admission_reason(self, req: _Request) -> str | None:
        """Shed decision (lock held): a reason string, or None = admit."""
        depth = len(self._queue)
        if depth >= self.queue_limit:
            return (f"overloaded: queue full "
                    f"(depth {depth} >= limit {self.queue_limit})")
        if req.deadline_s is not None and self._ewma_service_s > 0:
            est_wait = ((depth + self._active)
                        * self._ewma_service_s / self.num_workers)
            if est_wait > req.deadline_s:
                return (f"overloaded: deadline budget exceeded "
                        f"(estimated queue wait {est_wait:.3f}s > "
                        f"deadline {req.deadline_s:.3f}s)")
        return None

    def _failure_row(self, req: _Request, reason: str, *,
                     cancelled: bool = False) -> dict:
        res = CompileResult(
            name=req.dfg.name, ok=False, reason=reason, cancelled=cancelled,
            failure=classify_failure(False, reason, cancelled),
        )
        res.service = self._service_block(req, coalesced=False,
                                          speculative=False)
        return res.as_dict()

    def _service_block(self, req: _Request, *, coalesced: bool,
                       speculative: bool) -> dict:
        return {
            "tenant": req.tenant,
            "deadline_s": req.deadline_s,
            "queue_s": round(_time.perf_counter() - req.t_submit, 6),
            "coalesced": coalesced,
            "speculative": speculative,
        }

    def _set_row(self, req: _Request, row: dict) -> None:
        req.row = row
        req.done.set()

    def _finish(self, req: _Request, row: dict, *,
                speculative: bool = False) -> None:
        """Deliver the leader's row to it and every coalesced follower.

        The in-flight key is retired and the follower list snapshotted in
        one critical section: a concurrent identical submit either attached
        before (delivered below) or finds no leader and becomes one itself —
        attach-after-delivery (a follower nobody would ever wake) is
        impossible by construction.
        """
        with self._cv:
            self._inflight.pop(req.key, None)
            followers = list(req.followers)
        self._set_row(req, row)
        for f in followers:
            frow = json.loads(json.dumps(row))
            frow["service"] = self._service_block(
                f, coalesced=True, speculative=speculative)
            self._set_row(f, frow)

    # ------------------------------------------------------------- worker loop
    def _next_request(self) -> _Request | None:
        with self._cv:
            while not self._stopping:
                if self._queue:
                    req = self._queue.popleft()
                    self._active += 1
                    return req
                self._cv.wait(timeout=0.2)
            return None

    def _worker_done(self, req: _Request, service_s: float | None) -> None:
        # note: the in-flight key was already retired by _finish — popping it
        # here could evict a NEW leader admitted under the same key since
        with self._cv:
            self._active -= 1
            if service_s is not None:
                # EWMA of observed service time feeds deadline admission
                a = 0.2
                self._ewma_service_s = (
                    service_s if self._ewma_service_s == 0.0
                    else (1 - a) * self._ewma_service_s + a * service_s)
            self._cv.notify_all()

    def _worker_loop(self) -> None:
        while True:
            req = self._next_request()
            if req is None:
                return
            service_s = None
            try:
                now = _time.perf_counter()
                if req.expired(now):
                    # deadline burned entirely in the queue: report cancelled
                    # without running the mapper at all
                    with self._lock:
                        self.stats.cancelled_in_queue += 1
                        self.stats.completed += 1
                    self._finish(req, self._failure_row(
                        req, "cancelled: deadline expired in queue "
                        f"({now - req.t_submit:.3f}s queued > "
                        f"deadline {req.deadline_s:.3f}s)", cancelled=True))
                    continue
                t0 = _time.perf_counter()
                self._run(req)
                service_s = _time.perf_counter() - t0
            except Exception as exc:  # a bad request must never kill a worker
                self._finish(req, self._failure_row(
                    req, f"{type(exc).__name__}: {exc}"))
                with self._lock:
                    self.stats.completed += 1
                    self.stats.failed += 1
            finally:
                self._worker_done(req, service_s)
                self._maybe_rotate()

    def _run(self, req: _Request) -> None:
        """One admitted request through the session compiler (worker side)."""
        opts = req.opts
        extra: dict = {}
        if req.deadline_s is not None and not opts.deterministic:
            # remaining deadline budget at pickup becomes the mapper's wall
            # budget — the queue wait already spent part of the deadline
            remaining = req.deadline_s - (_time.perf_counter() - req.t_submit)
            extra["time_budget_s"] = max(
                0.001, min(opts.time_budget_s, remaining))

        def should_stop() -> bool:
            return self._stopping or req.expired()

        with obs.span("daemon.request", kernel=req.dfg.name,
                      tenant=req.tenant, rid=req.rid) as sp:
            # per-request option deltas ride through the same replace/
            # validate path as every frontend (already validated in submit)
            result = self.compiler.compile(
                req.dfg, should_stop=should_stop,
                **self._delta(opts, **extra))
            speculative = (
                result.source in ("memory", "disk")
                and self._cache_key(req.dfg, opts) in self._spec_keys
            )
            result.service = self._service_block(
                req, coalesced=False, speculative=speculative)
            if isinstance(result.metrics, dict) and "cache" in result.metrics:
                # speculative provenance lives next to the layer hit rates
                result.metrics["cache"]["speculative"] = speculative
            sp.set(ok=result.ok, ii=result.ii, source=result.source,
                   speculative=speculative)
        row = result.as_dict()
        self._record_completion(req, result, speculative)
        self._finish(req, row, speculative=speculative)

    def _record_completion(self, req, result, speculative: bool) -> None:
        with self._lock:
            self.stats.completed += 1
            if not result.ok:
                self.stats.failed += 1
            elif result.source == "memory":
                self.stats.warm_memory += 1
            elif result.source == "disk":
                self.stats.warm_disk += 1
            else:
                self.stats.solves += 1
            if speculative:
                self.stats.speculative_hits += 1
            if self.speculate:
                self._queue_speculation(req)

    # ------------------------------------------------------------- speculation
    def _queue_speculation(self, req: _Request) -> None:
        """(lock held) Enqueue unattempted neighbor variants of a completed
        request for the idle-time speculator."""
        for vopts in neighbor_options(req.opts):
            akey = self._cache_key(req.dfg, vopts)
            if akey in self._spec_attempted:
                continue
            self._spec_attempted[akey] = None
            while len(self._spec_attempted) > _ATTEMPT_LIMIT:
                self._spec_attempted.popitem(last=False)
            self._spec_pending.append((req.dfg, vopts))
            while len(self._spec_pending) > _RECENT_LIMIT:
                self._spec_pending.popleft()
        self._cv.notify_all()

    def _idle(self) -> bool:
        return not self._queue and self._active == 0

    def _speculator_loop(self) -> None:
        while True:
            with self._cv:
                while not self._stopping and not (
                        self._spec_pending and self._idle()):
                    self._cv.wait(timeout=0.1)
                if self._stopping:
                    return
                dfg, vopts = self._spec_pending.popleft()
            self._speculate_one(dfg, vopts)
            self._maintain_cache()

    def _speculate_one(self, dfg: DFG, vopts: CompileOptions) -> None:
        """Warm both cache layers for one neighbor variant; abandons the
        moment real traffic arrives (the workers' queue preempts idle work).
        """
        def should_stop() -> bool:
            return self._stopping or not self._idle()

        with self._lock:
            self.stats.speculative_attempts += 1
        budget = min(self.speculate_budget_s, vopts.time_budget_s)
        with obs.span("daemon.speculate", kernel=dfg.name,
                      hops=vopts.max_route_hops) as sp:
            try:
                result = self.compiler.compile(
                    dfg, should_stop=should_stop,
                    **self._delta(vopts, time_budget_s=budget))
            except Exception:
                # speculation is best-effort by definition
                return
            sp.set(ok=result.ok, ii=result.ii)
        if result.ok:
            with self._lock:
                self._spec_keys.add(self._cache_key(dfg, vopts))
                self.stats.speculative_warms += 1

    def _delta(self, opts: CompileOptions, **extra) -> dict:
        """Field-level diff of ``opts`` vs the session options, as per-call
        compile overrides (plus ``extra``)."""
        base = self.compiler.options
        d = {
            f: getattr(opts, f)
            for f in opts.as_dict()
            if getattr(opts, f) != getattr(base, f)
        }
        d.update(extra)
        return d

    def _maintain_cache(self) -> None:
        """Periodic disk-cache bounding (DESIGN.md §16.6): prune stale files
        and enforce the byte/age budget every ``prune_every`` speculative
        cycles — piggybacked on the idle thread so it never delays a request.
        """
        if self.cache_max_bytes is None and self.cache_max_age_s is None:
            return
        cache = self.compiler.cache
        if cache is None:
            return
        self._since_prune += 1
        if self._since_prune < self.prune_every:
            return
        self._since_prune = 0
        evicted_before = cache.stats.evictions
        cache.prune(max_bytes=self.cache_max_bytes,
                    max_age_s=self.cache_max_age_s)
        with self._lock:
            self.stats.cache_prunes += 1
            self.stats.cache_evictions += (
                cache.stats.evictions - evicted_before)

    # ---------------------------------------------------------- trace rotation
    def _maybe_rotate(self) -> None:
        if self._tracer is None:
            return
        with self._lock:
            self._since_rotate += 1
            due = self._since_rotate >= self.rotate_every
            if due:
                self._since_rotate = 0
        if due:
            self._rotate()

    def _rotate(self, force: bool = False) -> None:
        tracer = self._tracer
        if tracer is None or self.trace_dir is None:
            return
        events = tracer.drain()
        if not events and not force:
            return
        with self._lock:
            seq = self._rotate_seq
            self._rotate_seq += 1
        path = os.path.join(self.trace_dir, f"trace-{seq:04d}.json")
        try:
            tracer.write_segment(path, events)
        except OSError:
            pass  # tracing must never sink the daemon
