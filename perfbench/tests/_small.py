"""Small runs of the benchmark's cells on the CPU, for the tests."""

from __future__ import annotations

import tempfile
import time

from perfbench import harness

SMALL_KERNELS = ["bitcount", "fft", "gsm"]


def small_context(cell: str, *, seed: int = 2**31 + 7, trace: bool = False,
                  kernels=SMALL_KERNELS, streams: int = 8, iterations: int = 4):
    """The cell's context at a size the CPU path runs in a second: a few
    kernels, few streams, the cp time backend (z3 is not installed here)
    and 2 workers."""
    ctx = harness.make_context(cell, seed, trace, device="cpu")
    ctx.cell["traffic"].update(streams=streams, iterations=iterations)
    ctx.config["kernels"] = list(kernels)
    if ctx.cell["kind"] == "compile":
        ctx.config["compiler"]["backend"] = "cp"
        ctx.cell["traffic"]["jobs"] = 2
    return ctx


def run_small(ctx, seconds: float = 0.5):
    with tempfile.TemporaryDirectory(prefix="perfbench-test-") as scratch:
        ctx.scratch = scratch
        return harness.run_cell(ctx, seconds, time.perf_counter())
