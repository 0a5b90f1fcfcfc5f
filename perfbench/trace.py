"""Arithmetic over the traces of a ``--trace 1`` run.

Two sources:

* the profiler's Chrome trace of the window (``torch.profiler``, CPU and
  CUDA activities): device operations are the events of category
  ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the host's work is the
  ``cpu_op`` and ``user_annotation`` events, the latter the benchmark's own
  spans around each call into a layer (``harness.span``);
* the port's ``obs`` spans, which ``compile_many(trace_dir=...)`` writes as
  per-worker shards. ``self_times`` is ``tools/trace_report.py``'s self-time
  sweep, copied.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
#: The benchmark's span around the whole measured window.
WINDOW_SPAN = "perfbench.window"
_NAME_CHARS = 160


@dataclass
class DeviceTrace:
    """What a traced window did on the device, in seconds."""

    window_s: float
    busy_s: float
    op_s: dict[str, float] = field(default_factory=dict)       # by op name
    idle_s: dict[str, float] = field(default_factory=dict)     # gap time by host span
    htod_s: float = 0.0
    htod_count: int = 0

    def op_time(self, part: str) -> float:
        """Seconds of the operations whose name contains ``part``."""
        return sum(s for name, s in self.op_s.items() if part in name)

    def top_ops(self, n: int = 10) -> list[list]:
        return [[k, v] for k, v in sorted(self.op_s.items(), key=lambda kv: -kv[1])[:n]]

    def top_idle(self, n: int = 10) -> list[list]:
        return [[k, v] for k, v in sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:n]]


def _merged(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _host_labels(host: list[dict], times: list[float]) -> list[str]:
    """The innermost host span covering each of ``times`` (ascending);
    ``host`` sorted by start, parents first."""
    labels, active, i = [], [], 0
    for t in times:
        while i < len(host) and host[i]["ts"] <= t:
            active.append(host[i])
            i += 1
        active = [e for e in active if e["ts"] + e["dur"] >= t]
        labels.append(active[-1]["name"][:_NAME_CHARS] if active
                      else "host, outside any span or op")
    return labels


def read_device_trace(path: str) -> DeviceTrace:
    """Reduce a profiler Chrome trace to the window's device time."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
    if len(windows) != 1:
        raise ValueError(f"{len(windows)} '{WINDOW_SPAN}' spans in the trace, not 1")
    w_lo = float(windows[0]["ts"])
    w_hi = w_lo + float(windows[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and w_lo <= float(e["ts"]) <= w_hi]
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and e.get("name") != WINDOW_SPAN),
                  key=lambda e: (float(e["ts"]), -float(e["dur"])))
    for e in host:
        e["ts"], e["dur"] = float(e["ts"]), float(e["dur"])
    op_s: dict[str, float] = defaultdict(float)
    htod_s, htod_n = 0.0, 0
    spans = []
    for e in dev:
        lo = float(e["ts"])
        hi = min(lo + float(e["dur"]), w_hi)
        spans.append((lo, hi))
        op_s[e["name"][:_NAME_CHARS]] += (hi - lo) / 1e6
        if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]:
            htod_s += (hi - lo) / 1e6
            htod_n += 1
    busy = _merged(spans)
    gaps, edge = [], w_lo
    for lo, hi in busy + [[w_hi, w_hi]]:
        if lo > edge:
            gaps.append((edge, lo))
        edge = max(edge, hi)
    idle: dict[str, float] = defaultdict(float)
    for (lo, hi), label in zip(gaps, _host_labels(host, [(lo + hi) / 2 for lo, hi in gaps])):
        idle[label] += (hi - lo) / 1e6
    return DeviceTrace(
        window_s=(w_hi - w_lo) / 1e6,
        busy_s=sum(hi - lo for lo, hi in busy) / 1e6,
        op_s=dict(op_s), idle_s=dict(idle), htod_s=htod_s, htod_count=htod_n,
    )


def self_times(events):
    """Self time per span name: dur minus direct-children dur, per track.

    Copied from ``tools/trace_report.py``; returns (total, self, count)
    dicts keyed by span name, in the events' microseconds."""
    tracks = defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X":
            tracks[(ev.get("pid"), ev.get("tid"))].append(ev)
    total = defaultdict(float)
    self_t = defaultdict(float)
    count = defaultdict(int)
    for evs in tracks.values():
        # parents first: earlier start, then longer duration
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # (end_ts, name, child_dur_accum index into selfacc)
        selfacc = []
        for ev in evs:
            ts, dur, name = ev["ts"], ev["dur"], ev["name"]
            total[name] += dur
            count[name] += 1
            while stack and ts >= stack[-1][0] - 1e-6:
                stack.pop()
            if stack:
                selfacc[stack[-1][2]] += dur  # credit child time to parent
            selfacc.append(0.0)
            stack.append((ts + dur, name, len(selfacc) - 1))
        for ev, child_dur in zip(evs, selfacc):
            self_t[ev["name"]] += max(0.0, ev["dur"] - child_dur)
    return total, self_t, count
