"""One run of one cell: set-up, the measured window, the check, the result.

``run.py`` parses the command line and looks for the card; ``run_cell``
does the rest, so a test can drive a whole run on the CPU at a small size.

The cell's entry in ``BENCHMARK.json`` names its configuration; its file
``workloads/<cell>.json`` names its kind, which names the driver
``drivers/<kind>.py``. A driver is a class ``Driver(ctx)`` with

* ``setup()``: everything before the window (loading, lowering, warm-up);
* ``window(seconds) -> {metric: value}``: the measured window, which
  returns the cell's end-to-end metrics other than ``setup_s``;
* ``release()``: frees the device state once the peak has been read;
* ``verify() -> {name: (value, limit)}``: the numbers compared, after the
  window, against the plain reference;
* ``attempted``, ``failed``: counts of the window's units of work;
* ``record``: what the per-layer metric readers read;
* ``notes``: lines for standard error (passes, batches, what failed).

With ``--trace 1`` the window runs under ``torch.profiler``; each per-layer
metric of the cell is read by ``metrics/<metric>.py``'s ``read(record)``,
which returns None where it finds nothing to read.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import isolation, suite, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Context:
    """What a driver knows of its run."""

    cell_name: str
    cell: dict                 # workloads/<cell>.json
    config: dict               # configs/<config>.json
    seed: int
    trace: bool
    device: str = "cuda"
    scratch: str = ""          # a private directory under $TMPDIR, removed at exit

    def span(self, name: str):
        """The benchmark's own span around a call into a layer; a profiler
        annotation in trace runs, nothing otherwise."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: dict
    breakdown: dict | None = None
    notes: list = field(default_factory=list)

    def line(self) -> str:
        out = {"correct": self.correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks
        return json.dumps(out)


def benchmark() -> dict:
    return suite.read_json(ROOT / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def make_context(name: str, seed: int, trace_on: bool, device: str = "cuda") -> Context:
    entry = cell_entry(benchmark(), name)
    cell = suite.load_cell(name)
    if cell["config"] != entry["config"]:
        raise SystemExit(f"workloads/{name}.json names config {cell['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    return Context(cell_name=name, cell=cell, config=suite.load_config(entry["config"]),
                   seed=seed, trace=trace_on, device=device)


def load_driver(kind: str):
    return importlib.import_module(f"perfbench.drivers.{kind}")


def read_metric(name: str, record: dict):
    """``metrics/<name>.py``'s reading of the record, or None."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def _profiled_window(ctx: Context, drv, seconds: float):
    """The window under torch.profiler; returns (metrics, DeviceTrace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if ctx.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW_SPAN):
            e2e = drv.window(seconds)
        if ctx.device == "cuda":
            torch.cuda.synchronize()
    path = os.path.join(ctx.scratch, "profile.json")
    prof.export_chrome_trace(path)
    del prof
    dev = trace.read_device_trace(path)
    os.unlink(path)
    return e2e, dev


def device_info(ctx: Context) -> dict:
    import torch

    if ctx.device != "cuda":
        return {"platform": "cpu", "kind": "host CPU (test run)", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(ctx: Context, seconds: float, t_start: float) -> Result:
    """Set up, measure, check and read one run of the cell."""
    bench = benchmark()
    drv = load_driver(ctx.cell["kind"]).Driver(ctx)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    if ctx.trace:
        e2e, dev = _profiled_window(ctx, drv, seconds)
        drv.record["device"] = dev
    else:
        e2e, dev = drv.window(seconds), None
    device = device_info(ctx)
    drv.release()
    checks = drv.verify()
    correct = all(value <= limit for value, limit in checks.values())

    metrics = {}
    if ctx.trace:
        for m in bench["per_layer"]:
            if applies(m, ctx.cell_name):
                value = read_metric(m["name"], drv.record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = dev.busy_s
        device["window_s"] = dev.window_s
        breakdown = {"device_ops": dev.top_ops(), "idle_gaps": dev.top_idle()}
    else:
        e2e = {**e2e, "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if applies(m, ctx.cell_name):
                if m["name"] in e2e:
                    metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
                elif correct:
                    raise RuntimeError(f"the {ctx.cell['kind']} driver gives no {m['name']}")
        breakdown = None
    return Result(correct=correct, attempted=drv.attempted, failed=drv.failed,
                  metrics=metrics, device=device,
                  checks={k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
                  breakdown=breakdown, notes=drv.notes)


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    ctx = make_context(args.workload, args.seed, bool(args.trace))
    chips = cell_entry(benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="perfbench-") as scratch:
        ctx.scratch = scratch
        result = run_cell(ctx, args.seconds, t_start)
    found = isolation.forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for note in result.notes:
        print(f"perfbench: {note}", file=sys.stderr)
    for name, c in result.checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(result.line(), flush=True)
    return 0
