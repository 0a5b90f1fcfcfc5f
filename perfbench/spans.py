"""Device time and idle time by profiler annotation, from a traced window.

``trace.read_device_trace`` labels each idle gap by the innermost host span
or op over it and sums device time by op name. This reads the same Chrome
trace by its ``user_annotation`` events alone, the benchmark's spans and the
port's ``obs`` spans (``exec.*``, ``cgra_sim.*``, ``compile_many``'s):

* ``idle_by_annotation_s``: each idle gap of the window by the innermost
  annotation over its midpoint; ``cpu_op`` events do not count;
* ``op_s_by_annotation``: the device time of each kernel, memcpy and memset
  by the innermost annotation open when the host enqueued it, found by
  matching the device event's ``args.correlation`` with the CUDA runtime or
  driver call that carries the same id;

and ``probe_outcomes`` splits the compile workers' ``space.probe`` and
``time.probe`` spans by their ``outcome``, count and seconds per pass.

These are ``trace.read_device_trace``'s two fields to be, kept apart only
because the benchmark's existing files stay as they are here; the fixture
test ``perfbench/tests/test_perfbench_trace_spans.py`` pins them. The benchmark PR that
moves them into ``trace.py`` deletes this module.
"""

from __future__ import annotations

import json
from collections import defaultdict

from perfbench import trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside any annotation"


def _innermost(annotations: list[dict], times: list[float]) -> list[str]:
    """The innermost annotation over each of ``times``, in their order."""
    order = sorted(range(len(times)), key=times.__getitem__)
    labels = trace._host_labels(annotations, [times[i] for i in order])
    out = [""] * len(times)
    for i, label in zip(order, labels):
        out[i] = OUTSIDE if label == "host, outside any span or op" else label
    return out


def read_annotations(path: str) -> tuple[dict[str, float], dict[str, float]]:
    """(idle_by_annotation_s, op_s_by_annotation) of a profiler Chrome trace
    holding one ``trace.WINDOW_SPAN``, both in seconds."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == trace.WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
    if len(windows) != 1:
        raise ValueError(f"{len(windows)} '{trace.WINDOW_SPAN}' spans in the trace, not 1")
    w_lo = float(windows[0]["ts"])
    w_hi = w_lo + float(windows[0]["dur"])
    annotations = sorted(({**e, "ts": float(e["ts"]), "dur": float(e["dur"])}
                          for e in events if e.get("cat") == "user_annotation"
                          and e.get("name") != trace.WINDOW_SPAN),
                         key=lambda e: (e["ts"], -e["dur"]))
    dev = [e for e in events if e.get("cat") in trace.DEVICE_CATS
           and w_lo <= float(e["ts"]) <= w_hi]
    enqueued = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}

    spans, ops = [], []
    for e in dev:
        lo = float(e["ts"])
        hi = min(lo + float(e["dur"]), w_hi)
        spans.append((lo, hi))
        ops.append((enqueued.get(e.get("args", {}).get("correlation")), (hi - lo) / 1e6))
    op_s: dict[str, float] = defaultdict(float)
    matched = [(t, s) for t, s in ops if t is not None]
    for label, (_, s) in zip(_innermost(annotations, [t for t, _ in matched]), matched):
        op_s[label] += s
    for t, s in ops:
        if t is None:
            op_s["no enqueuing call in the trace"] += s

    gaps, edge = [], w_lo
    for lo, hi in trace._merged(spans) + [[w_hi, w_hi]]:
        if lo > edge:
            gaps.append((edge, lo))
        edge = max(edge, hi)
    idle: dict[str, float] = defaultdict(float)
    for (lo, hi), label in zip(gaps, _innermost(annotations,
                                                [(lo + hi) / 2 for lo, hi in gaps])):
        idle[label] += (hi - lo) / 1e6
    return dict(idle), dict(op_s)


def probe_outcomes(events: list[dict], passes: int) -> dict:
    """The workers' probe spans by name and ``outcome``: [count, seconds]
    per pass."""
    out: dict = defaultdict(lambda: defaultdict(lambda: [0.0, 0.0]))
    for e in events:
        if e.get("ph") == "X" and e.get("name") in ("space.probe", "time.probe"):
            cell = out[e["name"]][e.get("args", {}).get("outcome", "none")]
            cell[0] += 1 / passes
            cell[1] += e["dur"] / 1e6 / passes
    return {name: dict(split) for name, split in out.items()}

