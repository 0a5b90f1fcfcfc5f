"""Structured compile-pipeline tracing + metrics (DESIGN.md §15).

A hierarchical span tracer threaded through the whole pipeline::

    from repro_torch import obs

    with obs.span("time.probe", ii=4):
        ...                       # timed; nests under the enclosing span
    obs.event("cache.memory.hit", ii=4)   # zero-duration instant
    obs.incr("space.restarts")            # named counter on the tracer

Design contract (the "overhead contract"):

* **Disabled is the default and costs almost nothing.** The module-level
  ``_ACTIVE`` tracer is ``None`` unless a CLI or test installs one;
  ``span()`` / ``event()`` / ``incr()`` check it first and return a shared
  ``_NULL_SPAN`` singleton without allocating. Instrumentation sites can
  therefore stay inline in hot loops (mapper rounds, solver probes).
* **Stdlib only, imports nothing else of ``repro_torch``.** This module
  must be importable from every layer without cycles.
* **One timeline across processes.** Timestamps are wall-epoch anchored
  (``time.time()`` at tracer start + ``perf_counter`` deltas), so span
  shards written by service worker processes merge onto the parent's
  timeline with pid/tid attribution intact.

**Spans on the profiler's clock.** The layer that imports torch
(``repro_torch/kernels/__init__.py``) installs a profiler hook with
:func:`install_profiler_hook`: a check that ``torch.profiler`` records in
this process and a factory of ``torch.profiler.record_function``. While the
profiler records, every ``span()`` also opens an annotation of its name, so
the span shows in the profiler's Chrome trace as a ``user_annotation`` on the
clock of every kernel and copy, with or without a tracer; with both on, the
span goes to both. With neither, ``span()`` returns ``_NULL_SPAN`` after one
read of ``_ACTIVE`` and one call of the check, and never enters the
profiler. A forked child inherits the profiler's flag but not a working
profiler (the compile service forks its workers while a traced benchmark
window records), so the hook drops itself in every forked child: a worker
never calls into the profiler.

Spans keep no per-thread stack of open names; the hierarchy is recovered
from the events' times, as ``tools/trace_report.py`` does.

Serialization is the Chrome trace-event JSON flavor (``"X"`` complete
events, ``"i"`` instants, ``"M"`` metadata) that Perfetto / ``chrome://
tracing`` load directly; ``tools/trace_report.py`` summarizes the same
file into a self-time table.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

__all__ = [
    "Tracer",
    "append_shard",
    "enabled",
    "env_enabled",
    "event",
    "get_tracer",
    "incr",
    "install_profiler_hook",
    "install_tracer",
    "merge_shards",
    "session",
    "span",
    "tracing",
]

# The process-global active tracer. ``None`` means tracing is disabled and
# every obs call short-circuits through the no-op fast path below.
_ACTIVE: "Tracer | None" = None

# The profiler hook: ``_PROFILING()`` is true while torch.profiler records in
# this process, ``_ANNOTATE(name)`` opens a profiler annotation. Both ``None``
# until the torch layer installs them, and again in a forked child.
_PROFILING = None
_ANNOTATE = None


def install_profiler_hook(profiling, annotate) -> None:
    """Let spans open profiler annotations while ``profiling()`` is true;
    ``annotate(name)`` returns a context manager."""
    global _PROFILING, _ANNOTATE
    _PROFILING, _ANNOTATE = profiling, annotate


def _drop_profiler_hook() -> None:
    global _PROFILING, _ANNOTATE
    _PROFILING = _ANNOTATE = None


os.register_at_fork(after_in_child=_drop_profiler_hook)


def env_enabled() -> bool:
    """True when the ``REPRO_TRACE`` environment variable is truthy."""
    return os.environ.get("REPRO_TRACE", "").strip().lower() not in (
        "", "0", "false", "no", "off",
    )


def enabled() -> bool:
    """True when a tracer is currently installed."""
    return _ACTIVE is not None


def get_tracer() -> "Tracer | None":
    return _ACTIVE


class _NullSpan:
    """Shared no-op span: the disabled-mode fast path (zero allocation)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):  # pragma: no cover - trivial
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span: records an ``"X"`` complete event on exit when a tracer
    is installed, and holds a profiler annotation open when one is given."""

    __slots__ = ("_tracer", "_annotation", "name", "args", "_t0", "_ts")

    def __init__(self, tracer: "Tracer | None", name: str, args: dict,
                 annotation=None):
        self._tracer = tracer
        self._annotation = annotation
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._ts = 0.0

    def __enter__(self):
        if self._annotation is not None:
            self._annotation.__enter__()
        if self._tracer is not None:
            self._t0 = time.perf_counter()
            self._ts = self._tracer._now_us()
        return self

    def __exit__(self, *exc):
        if self._tracer is not None:
            dur_us = (time.perf_counter() - self._t0) * 1e6
            self._tracer._emit_complete(self.name, self._ts, dur_us, self.args)
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return False

    def set(self, **attrs):
        """Attach/override attributes after the span started."""
        self.args.update(attrs)
        return self


class Tracer:
    """Collects trace events for one process; thread-safe appends.

    Events are stored as Chrome trace-event dicts (``ts``/``dur`` in
    microseconds since the Unix epoch, so shards from different processes
    share one timeline).
    """

    def __init__(self, process_name: str = "repro"):
        self.process_name = process_name
        self.pid = os.getpid()
        # wall-epoch anchor: wall time at construction + perf_counter deltas
        self._epoch_us = time.time() * 1e6
        self._anchor = time.perf_counter()
        self._lock = threading.Lock()
        self.events: list[dict] = []
        self.counters: dict[str, int] = {}

    # -- time ------------------------------------------------------------
    def _now_us(self) -> float:
        return self._epoch_us + (time.perf_counter() - self._anchor) * 1e6

    # -- event emission ---------------------------------------------------
    def _emit_complete(self, name, ts_us, dur_us, args) -> None:
        ev = {
            "name": name,
            "cat": name.split(".", 1)[0],
            "ph": "X",
            "ts": round(ts_us, 1),
            "dur": round(dur_us, 1),
            "pid": self.pid,
            "tid": threading.get_ident() % 1_000_000,
            "args": args,
        }
        with self._lock:
            self.events.append(ev)

    def emit_instant(self, name: str, args: dict) -> None:
        ev = {
            "name": name,
            "cat": name.split(".", 1)[0],
            "ph": "i",
            "ts": round(self._now_us(), 1),
            "pid": self.pid,
            "tid": threading.get_ident() % 1_000_000,
            "s": "t",
            "args": args,
        }
        with self._lock:
            self.events.append(ev)

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def adopt(self, events: list) -> None:
        """Merge externally produced events (worker shards) into this trace."""
        with self._lock:
            self.events.extend(events)

    def drain(self) -> list[dict]:
        """Atomically take (and clear) the accumulated events.

        The rotation primitive for unbounded-lifetime sessions (the compile
        daemon, DESIGN.md §16.5): the caller serializes each drained segment
        to its own Chrome-JSON file so the in-memory event list never grows
        for the life of the process. Counters are cumulative and are NOT
        cleared — they describe the session, not the segment.
        """
        with self._lock:
            events, self.events = self.events, []
        return events

    def write_segment(self, path: str, events: list[dict]) -> None:
        """Write one drained segment as a standalone Chrome trace document
        (same schema as :meth:`write`, so ``tools/trace_report.py`` loads
        rotated daemon segments and one-shot CLI traces identically)."""
        pids = sorted({e["pid"] for e in events} | {self.pid})
        meta = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": self.process_name if pid == self.pid
                     else f"worker-{pid}"},
        } for pid in pids]
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        with self._lock:
            if self.counters:
                doc["otherData"] = {"counters": dict(self.counters)}
        with open(path, "w") as f:
            json.dump(doc, f)

    # -- serialization ----------------------------------------------------
    def metadata_events(self) -> list[dict]:
        pids = sorted({e["pid"] for e in self.events} | {self.pid})
        meta = []
        for pid in pids:
            label = self.process_name if pid == self.pid else f"worker-{pid}"
            meta.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": label},
            })
        return meta

    def to_chrome(self) -> dict:
        """The Perfetto-loadable Chrome trace-event JSON document."""
        with self._lock:
            events = list(self.events)
        doc = {
            "traceEvents": self.metadata_events() + events,
            "displayTimeUnit": "ms",
        }
        if self.counters:
            doc["otherData"] = {"counters": dict(self.counters)}
        return doc

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


# -- module-level API (the only names instrumentation sites use) ----------

def span(name: str, **attrs):
    """Context manager timing a named span; also a profiler annotation while
    the profiler records; no-op when neither is on."""
    t = _ACTIVE
    profiling = _PROFILING
    if profiling is not None and profiling():
        return _Span(t, name, attrs, _ANNOTATE(name))
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, attrs)


def event(name: str, **attrs) -> None:
    """Record a zero-duration instant event; no-op when disabled."""
    t = _ACTIVE
    if t is not None:
        t.emit_instant(name, attrs)


def incr(name: str, n: int = 1) -> None:
    """Bump a named counter on the active tracer; no-op when disabled."""
    t = _ACTIVE
    if t is not None:
        t.incr(name, n)


def install_tracer(tracer: "Tracer | None") -> "Tracer | None":
    """Install ``tracer`` as the process-global tracer; return the previous.

    The non-scoped variant of :func:`tracing` for callers whose lifetime is
    not a ``with`` block — the compile daemon installs its session tracer at
    start and restores the previous one at shutdown (DESIGN.md §16.5).
    """
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    return prev


@contextmanager
def tracing(tracer: "Tracer | None" = None):
    """Install ``tracer`` (or a fresh one) as the process-global tracer."""
    global _ACTIVE
    t = tracer if tracer is not None else Tracer()
    prev = _ACTIVE
    _ACTIVE = t
    try:
        yield t
    finally:
        _ACTIVE = prev


@contextmanager
def session(path: "str | None" = None, *, enable: bool = False,
            process_name: str = "repro"):
    """CLI entry point: trace when asked, write Chrome JSON on exit.

    Installs a tracer when ``path`` is given, ``enable`` is true, or
    ``REPRO_TRACE`` is set — otherwise yields ``None`` and the whole
    pipeline stays on the no-op fast path. When a tracer is already
    active (nested session), it is reused and ownership stays outside.
    """
    global _ACTIVE
    if not (path or enable or env_enabled()):
        yield None
        return
    if _ACTIVE is not None:
        yield _ACTIVE
        return
    t = Tracer(process_name=process_name)
    _ACTIVE = t
    try:
        yield t
    finally:
        _ACTIVE = None
        if path:
            t.write(path)


# -- cross-process shards -------------------------------------------------

def append_shard(trace_dir: str, events: list, counters: "dict | None" = None) -> None:
    """Append this process's events to its per-pid JSONL shard file.

    Workers call this after each job; the parent merges with
    :func:`merge_shards`. One file per pid means no cross-process locking.
    """
    if not events and not counters:
        return
    path = os.path.join(trace_dir, f"shard-{os.getpid()}.jsonl")
    lines = [json.dumps(e) for e in events]
    if counters:
        lines.append(json.dumps({"_counters": counters}))
    with open(path, "a") as f:
        f.write("\n".join(lines) + "\n")


def merge_shards(trace_dir: str) -> "tuple[list[dict], dict[str, int]]":
    """Read every per-pid shard in ``trace_dir``; return (events, counters)."""
    events: list[dict] = []
    counters: dict[str, int] = {}
    try:
        names = sorted(os.listdir(trace_dir))
    except OSError:
        return events, counters
    for fn in names:
        if not (fn.startswith("shard-") and fn.endswith(".jsonl")):
            continue
        try:
            with open(os.path.join(trace_dir, fn)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    if "_counters" in rec:
                        for k, v in rec["_counters"].items():
                            counters[k] = counters.get(k, 0) + v
                    else:
                        events.append(rec)
        except (OSError, ValueError):
            continue  # a torn shard must not sink the batch
    return events, counters
