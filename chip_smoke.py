#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and the CUDA
toolkit (``nvcc``); it builds the port's CUDA kernel into ``build/`` first.
It drives the port's main path — map a loop with the port's mapper, lower
the mapping, execute it batched on the card through the hand-written
``cgra_sim`` kernel — and fails (non-zero exit, no result line) if any phase
fails:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles ``src/repro_torch/kernels/csrc/cgra_sim.cu`` with nvcc;
3. small programs: the kernel's trace equals the plain PyTorch version on
   the card (``torch.equal``) and the numpy oracle, and its store streams
   match the scalar interpreter on lane 0;
4. main path at full size: hotspot3D, backprop and aes mapped on a 20x20
   grid and run over 16384 streams x 64 iterations; kernel launches are
   counted over this phase alone. Each trace equals the plain version on
   the card, and 8 sampled lanes equal the oracle exactly;
5. timing: the kernel (zero-fill of the trace included) and the plain
   version, with CUDA events, beside the least time the card could take.

The line before the last is ``{"kernels": [...]}``, one entry per kernel;
the last is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import CGRA, DFG, Edge, map_dfg, running_example  # noqa: E402
from repro_torch.core.benchsuite import load_suite  # noqa: E402
from repro_torch.core.dfg import OP_ARITY  # noqa: E402
from repro_torch.core.simulate import interpret_dfg  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cgra_sim import cgra_sim, cgra_sim_torch  # noqa: E402
from repro_torch.kernels.ops import cgra_run, compile_program  # noqa: E402
from repro_torch.kernels.ref import cgra_sim_reference  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32 rate
# outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

FULL_GRID = (20, 20)
FULL_BATCH = 16384
FULL_ITERS = 64
FULL_KERNELS = ("hotspot3D", "backprop", "aes")
SAMPLED_LANES = 8
TIMED_RUNS = 10


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def seeded_inputs(program, num_iters: int, batch: int, seed: int) -> dict:
    """Input streams as the JAX package's tests make them: uniform(-4, 4)
    rounded to 2 decimals, one numpy generator per program."""
    rng = np.random.default_rng(seed)
    return {v: rng.uniform(-4, 4, (num_iters, batch)).astype(np.float32).round(2)
            for v in program.input_nodes()}


def stacked(program, inputs: dict) -> torch.Tensor:
    return torch.stack([torch.as_tensor(inputs[v], device="cuda")
                        for v in program.input_nodes()]).contiguous()


def map_program(dfg: DFG, cgra: CGRA):
    res = map_dfg(dfg, cgra, time_budget_s=30)
    check(res.ok, f"{dfg.name} on {cgra.rows}x{cgra.cols}: {res.reason}")
    return compile_program(res.mapping)


# ------------------------------------------------------------------ phase 3

def opcover_dfg() -> DFG:
    """Every opcode, chained like straight-line code (the JAX package's
    tests/test_kernels_cgra.py::test_all_float_ops_covered)."""
    mid = ["add", "sub", "mul", "div", "min", "max", "neg", "abs", "mov",
           "cmp", "and", "or", "xor", "shl", "shr", "not"]
    ops = ["input", "input", "const"] + mid + ["store"]
    edges, prev = [], 2
    for v in range(3, 3 + len(mid)):
        edges.append(Edge(prev, v))
        if OP_ARITY[ops[v]] == 2:
            edges.append(Edge(v % 2, v))
        prev = v
    edges.append(Edge(prev, len(ops) - 1))
    return DFG(num_nodes=len(ops), edges=edges, ops=ops, name="opcover")


def small_cases():
    re_ = running_example()
    yield "running_example 2x2 b8", re_, CGRA(2, 2), 5, 8, None
    yield "running_example 3x3 b32", re_, CGRA(3, 3), 4, 32, None
    yield "running_example 4x4 b128", re_, CGRA(4, 4), 4, 128, None
    yield "opcover 3x3", opcover_dfg(), CGRA(3, 3), 3, 8, None
    accum = DFG(num_nodes=4, edges=[Edge(0, 1), Edge(1, 2), Edge(2, 1, 1), Edge(2, 3)],
                ops=["input", "phi", "mov", "store"], name="accum")
    yield "phi recurrence 2x2", accum, CGRA(2, 2), 6, 8, None
    big = DFG(num_nodes=4, edges=[Edge(0, 2), Edge(1, 2), Edge(2, 3)],
              ops=["input", "input", "add", "store"], name="overflow")
    yield "1e20 operands 2x2", big, CGRA(2, 2), 2, 8, 1e20


def phase_small() -> None:
    for label, dfg, cgra, iters, batch, const in small_cases():
        prog = map_program(dfg, cgra)
        if const is None:
            inputs = seeded_inputs(prog, iters, batch, seed=0)
        else:
            inputs = {v: np.full((iters, batch), const, np.float32)
                      for v in prog.input_nodes()}
        tables = prog.sim_tables().to("cuda")
        x = stacked(prog, inputs)
        got = cgra_sim(tables, x)
        plain = cgra_sim_torch(tables, x)
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"{label}: kernel != plain version")
        outs_r, trace_r = cgra_sim_reference(prog, inputs, iters)
        check(np.array_equal(got.cpu().numpy(), trace_r), f"{label}: kernel != oracle")
        ref = interpret_dfg(dfg, {v: [float(a) for a in inputs[v][:, 0]] for v in inputs},
                            iters)
        m = prog.mapping
        for v, stream in ref.items():
            cyc = [m.t_abs[v] + it * m.ii for it in range(iters)]
            lane0 = got[cyc, m.placement[v], 0].cpu().numpy()
            np.testing.assert_allclose(lane0, np.asarray(stream, np.float32),
                                       rtol=1e-6, atol=1e-6, err_msg=label)
        if const is not None:
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite trace")
        log(f"  ok  {label}: II={m.ii} C={got.shape[0]} pes={got.shape[1]} B={batch}")


# ------------------------------------------------------------------ phase 4

def drive_main_path(suite: dict) -> dict:
    """Map, lower and run each full-size program through ``cgra_run``; the
    entry points a user calls. Returns per-program state for the checks."""
    runs = {}
    for name in FULL_KERNELS:
        t0 = time.perf_counter()
        prog = map_program(suite[name], CGRA(*FULL_GRID))
        map_s = time.perf_counter() - t0
        inputs = seeded_inputs(prog, FULL_ITERS, FULL_BATCH, seed=1)
        outs, trace = cgra_run(prog, inputs, FULL_ITERS, device="cuda")
        torch.cuda.synchronize()
        runs[name] = dict(prog=prog, inputs=inputs, outs=outs, trace=trace,
                          map_s=map_s)
    return runs


def check_full(name: str, run: dict) -> float:
    prog, inputs, trace = run["prog"], run["inputs"], run["trace"]
    m = prog.mapping
    C = m.schedule_length + (FULL_ITERS - 1) * m.ii
    check(tuple(trace.shape) == (C, prog.num_pes, FULL_BATCH), f"{name}: trace shape")
    check(bool(torch.isfinite(trace).all()), f"{name}: non-finite trace")
    for v, out in run["outs"].items():
        check(tuple(out.shape) == (FULL_ITERS, FULL_BATCH), f"{name}: store {v} shape")
    tables = prog.sim_tables().to("cuda")
    plain = cgra_sim_torch(tables, stacked(prog, inputs))
    torch.cuda.synchronize()
    same = torch.equal(trace, plain)
    # max |kernel - plain| a few cycles at a time: a whole-trace difference
    # would need as much memory again as the trace
    err = max(float((trace[c:c + 16] - plain[c:c + 16]).abs().max())
              for c in range(0, trace.shape[0], 16))
    del plain
    check(same, f"{name}: kernel != plain version (max |d| {err})")
    lanes = np.random.default_rng(2).choice(FULL_BATCH, SAMPLED_LANES, replace=False)
    _, ref = cgra_sim_reference(prog, inputs, FULL_ITERS, lanes=lanes)
    got = trace[:, :, torch.as_tensor(lanes, device="cuda")].cpu().numpy()
    check(np.array_equal(got, ref), f"{name}: sampled lanes != oracle")
    log(f"  ok  {name}: II={m.ii} C={C} ring={prog.ring} nodes={m.dfg.num_nodes} "
        f"map {run['map_s']:.2f} s; trace == plain, lanes {sorted(lanes.tolist())} "
        f"== oracle")
    return err


# ------------------------------------------------------------------ phase 5

def time_ms(fn, runs: int) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(prog, tables, x: torch.Tensor) -> tuple[float, str, int]:
    """Least time for the card: bytes (each input once, the trace once) over
    HBM bandwidth, or the ops the run's firing nodes do over the f32 rate."""
    C = tables.num_cycles(FULL_ITERS)
    trace_bytes = C * prog.num_pes * FULL_BATCH * 4
    table_bytes = sum(getattr(tables, k).numel() * 4 for k in tables.TENSOR_FIELDS)
    nbytes = trace_bytes + x.numel() * 4 + table_bytes
    firings = prog.mapping.dfg.num_nodes * FULL_ITERS * FULL_BATCH
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = firings / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes", nbytes) if by_bytes >= by_ops else (by_ops, "operations", nbytes)


def phase_timing(runs: dict) -> dict:
    rows = {}
    for name, run in runs.items():
        prog = run["prog"]
        tables = prog.sim_tables().to("cuda")
        x = stacked(prog, run["inputs"])
        shape = (tables.num_cycles(FULL_ITERS), prog.num_pes, FULL_BATCH)
        ms = time_ms(lambda: cgra_sim(tables, x), TIMED_RUNS)
        # the wrapper's torch.zeros alone: the part of `ms` that is the fill
        fill_ms = time_ms(lambda: torch.zeros(shape, device="cuda"), TIMED_RUNS)
        plain_ms = time_ms(lambda: cgra_sim_torch(tables, x), 3)
        bound_ms, bound_by, nbytes = bound(prog, tables, x)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, bytes=nbytes)
        log(f"  {name}: kernel {ms:.4f} ms (median of {TIMED_RUNS}, zero-fill "
            f"included; the fill alone {fill_ms:.4f} ms), plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B), "
            f"{bound_ms / ms:.1%} of bound")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA GPU",
              file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[1] device: {kind} x{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    lib = _build.build("cgra_sim", verbose=True)
    log(f"[2] build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    log("[3] small programs: kernel vs plain version, oracle and interpreter")
    phase_small()

    log(f"[4] main path: {', '.join(FULL_KERNELS)} on {FULL_GRID[0]}x{FULL_GRID[1]}, "
        f"B={FULL_BATCH}, num_iters={FULL_ITERS}")
    suite = load_suite(list(FULL_KERNELS))
    torch.cuda.reset_peak_memory_stats()
    cgra_sim.launches = 0
    runs = drive_main_path(suite)
    launches = cgra_sim.launches
    log(f"  cgra_sim launches on the main path: {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches >= 1, "the main path never launched cgra_sim")
    max_err = 0.0
    for name in reversed(FULL_KERNELS):   # largest trace first, then freed
        max_err = max(max_err, check_full(name, runs[name]))
        runs[name].pop("trace")
        runs[name].pop("outs")
        torch.cuda.empty_cache()

    log(f"[5] timing on {smi}")
    rows = phase_timing(runs)
    main_row = rows[FULL_KERNELS[0]]
    print(json.dumps({"kernels": [{
        "name": "cgra_sim",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cgra_sim.cu",
        "replaces": "src/repro/kernels/cgra_sim.py:75",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
