#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and the CUDA
toolkit (``nvcc``); it builds the port's CUDA kernels into ``build/`` first.
It drives the port's paths through the entry points a user calls — map
a loop with the port's mapper (directly, through the compiler API or through
the compile daemon), lower it and execute it batched through the
hand-written ``cgra_sim`` kernel; serve qwen3-0.6b at full width with its
prefill attention in the hand-written ``flash_attention`` kernel; train
qwen3-0.6b at full width with attention's forward and gradient in the
hand-written ``flash_attention`` and ``flash_attention_bwd`` kernels — and
fails (non-zero exit, no result line) if any phase fails:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles ``src/repro_torch/kernels/csrc/cgra_sim.cu``,
   ``flash_attention.cu`` and ``flash_attention_bwd.cu`` with nvcc, one
   process each, in parallel;
3. small programs: the cgra_sim kernel's trace equals the plain PyTorch
   version on the card (``torch.equal``) and the numpy oracle, and its store
   streams match the scalar interpreter on lane 0;
4. CGRA path at full size: hotspot3D, backprop and aes mapped on a 20x20
   grid and run over 16384 streams x 64 iterations; kernel launches are
   counted over this phase alone. Each trace equals the plain version on
   the card, and 8 sampled lanes equal the oracle exactly;
5. timing of cgra_sim (zero-fill of the trace included) and its plain
   version, with CUDA events, beside the least time the card could take;
6. the flash kernels against their plain version on every shape and option
   of the JAX package's flash sweep in f32 (CUDA-core kernel) and in bf16
   (tensor-core kernel), plus D = 192 and 256, f16, S below one tile, all
   rows masked, a ragged S through the padding path and the serve shape
   (2e-5 in f32, 2e-2 in bf16/f16); each case checks which kernel ran;
7. serving path at full width: qwen3-0.6b (28 layers, d 1024, 16/8 heads,
   head_dim 128, vocab 151936, bf16, seeded random weights) serves 8
   requests in batches of 4, prompt 2048, 32 generated tokens; flash
   launches, and those of the tensor-core kernel, are counted over this
   phase alone (each >= 28 per batch). Prefill and decode are timed and
   profiled (torch.profiler). The kernel is held against its plain version
   on the q/k/v that layers 0 and 27 produce in a bf16 prefill. In f32, one
   batch's prefill and teacher-forced decode logits match the same path
   with the plain attention version;
8. timing of the flash kernel at the serve shape in turns with
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it), beside its bound and its plain version, and of the CUDA-core kernel
   on the same shape in f32;
9. the flash backward kernels against their plain version
   (``flash_attention_backward_torch``, fed the same q, k, v, output,
   log-sum-exp and d out) and against autograd through
   ``flash_attention_torch``, on every case of phase 6 (the padded one
   through autograd of ``flash_attention_padded``), bf16 and f16 at D 64
   and 128 with GQA groups 1, 2 and 4, window, softcap, S below one tile
   and a ragged S, the training shape, and the q, k, v and d out that
   layers 0 and 27 see in one bf16 training step of phase 10's model;
   within 2e-5 (f32) / 2e-2 (bf16, f16) of each gradient's max |g|; the
   forward's log-sum-exp against the plain one; each case checks which
   backward ran (tensor cores for bf16/f16 at D 64 and 128, CUDA cores
   otherwise), that the autograd Function gives the same gradients and
   that the tensor-core backward gives the same bits twice;
10. training path at full width: qwen3-0.6b (bf16, remat) trains 8 steps
   of batch 4 x 2048 through ``launch.train``'s ``make_state`` /
   ``make_step`` and ``runtime.run_training`` (AdamW at the CLI's
   defaults, a fresh checkpoint directory under ``build/``), then 2 steps
   with gradient compression. No restart, finite losses, the first near
   ln(vocab), >= 28 forward, tensor-core forward, backward and tensor-core
   backward launches per step (counted over this phase alone), and the
   saved checkpoint restores bit for bit. Reports ms/step, tokens/s, peak
   memory, the save's time and a profile of one step. Then one f32 step at
   batch 1 x 2048 through the kernels (the CUDA-core backward) against the
   same step with the plain attention versions: loss within 1e-5 (of
   max(1, |loss|)), each gradient leaf within 1e-3 of its max |g|;
11. timing of the tensor-core backward at the training shape in turns with
   the backward of ``scaled_dot_product_attention`` (a yardstick only),
   beside its bound, its plain version and the CUDA-core backward on the
   same shape in f32.
12. compiler API path at full size, through the entry points users call:
   the 17-kernel suite premapped cold onto a 20x20 grid by ``python -m
   repro_torch.compile`` (a subprocess with no CUDA context, 4 forked
   workers, a fresh persistent cache under ``build/``); a warm
   ``repro_torch.api.Compiler`` session on the same cache (17 disk hits, 0
   solves, the mappings the cold run wrote); every warm mapping executed by
   ``cgra_run`` at 16384 streams x 64 iterations; heartwall and backprop
   mapped on the ``mesh_50x50`` preset by the annealing engine and executed
   at the same size (traces of 43 and 53 GB, checked against the plain
   version in lane chunks), heartwall's kernel timed beside its bound; the
   suite on the heterogeneous ``satmapit_edge_mem_4x4`` preset mapped and
   executed; ``examples/quickstart_torch.py`` run on the card. cgra_sim
   launches are counted over the phase's executions alone.
13. compile daemon, tracing frontend, fuzz generator and stage placement:
   ``python -m repro_torch.daemon serve`` (a subprocess, 4 worker threads,
   20x20, fast profile, a fresh cache and trace directory under ``build/``,
   the socket in a short temporary directory) answers ping, then the suite
   from 26 client threads at once (hotspot3D, backprop and aes from 4 each):
   every row ok, every request accounted for by solves, warm hits and
   coalescing, no kernel solved twice, a clean shutdown and rotated trace
   segments that ``tools/trace_report.py`` reads; a warm
   ``repro_torch.api.Compiler`` on the daemon's cache (17 disk hits, the
   daemon's IIs), each mapping executed at 16384 x 64 as in phase 12. Three
   loops traced by ``repro_torch.core.frontend.trace_loop`` (a
   multiply-accumulate, whose stores equal a numpy running sum, a mixed-op
   body and one with every overloaded operator) mapped on 20x20 and executed
   at the same size. ``random_dfg`` seeds 0-203 on ``tests/
   test_differential.py``'s three fabrics, mapped deterministically by the
   exact engine and executed at 4096 x 32: each trace equals the plain
   version and 8 lanes the oracle. ``examples/pipeline_placement_torch.py``.
   cgra_sim launches are counted over the phase alone.

The line before the last is ``{"kernels": [...]}``, one entry per kernel;
the last is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import Compiler, resolve_options  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import CGRA, DFG, Edge, map_dfg, op_class, running_example  # noqa: E402
from repro_torch.core.benchsuite import load_suite  # noqa: E402
from repro_torch.core.daemon import DaemonClient, DaemonError  # noqa: E402
from repro_torch.core.frontend import trace_loop  # noqa: E402
from repro_torch.core.fuzz import random_dfg  # noqa: E402
from repro_torch.core.dfg import OP_ARITY  # noqa: E402
from repro_torch.core.mapper import clear_mapping_cache  # noqa: E402
from repro_torch.core.simulate import check_equivalence, interpret_dfg  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cgra_sim import cgra_sim, cgra_sim_torch  # noqa: E402
from repro_torch.checkpoint import restore  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_backward, flash_attention_backward_torch,
    flash_attention_lse, flash_attention_padded, flash_attention_torch,
)
from repro_torch.kernels.ops import cgra_run, compile_program  # noqa: E402
from repro_torch.kernels.ref import cgra_sim_reference  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.launch.train import make_state, make_step  # noqa: E402
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import FaultConfig, run_training  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths, unflatten  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 rate
# outside the tensor cores and the dense bf16 tensor-core rate, at the full
# 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12

FULL_GRID = (20, 20)
FULL_BATCH = 16384
FULL_ITERS = 64
FULL_KERNELS = ("hotspot3D", "backprop", "aes")
SAMPLED_LANES = 8
TIMED_RUNS = 10
FLASH_INNER = 10      # flash launches per timing (see time_ms)

KERNELS = ("cgra_sim", "flash_attention", "flash_attention_bwd")

SERVE_ARCH = "qwen3-0.6b"
SERVE_REQUESTS = 8
SERVE_BATCH = 4
SERVE_PROMPT = 2048
SERVE_GEN = 32
SERVE_CACHE_LEN = SERVE_PROMPT + SERVE_GEN + 8     # as the serve CLI sizes it
# the serve shape of the flash kernel: qwen3-0.6b prefill of one batch
SERVE_SHAPE = (SERVE_BATCH, 16, 8, SERVE_PROMPT, 128)
# f32 logits of the kernel path against the plain-attention path. Logits are
# O(1); the two attention versions differ by ~1e-6 in f32 (sum order, FMA),
# which 28 layers may amplify by 10-100x. 1e-4 keeps that margin, while a
# wrong mask, scale or head mapping moves logits by far more.
SERVE_F32_TOL = 1e-4

TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 8
TRAIN_TIMED_FROM = 2          # ms/step: the median over steps 3..8
COMPRESSION_STEPS = 2
# the flash kernels' shape in a training step of qwen3-0.6b
TRAIN_SHAPE = (TRAIN_BATCH, 16, 8, TRAIN_SEQ, 128)
# The first loss of random weights: the final rms_norm gives hidden states
# of unit rms and the tied embedding (std 0.02) logits of std ~0.02*sqrt(d)
# = 0.64, so lse ~ ln(vocab) + 0.64^2/2 = 12.13 and the loss, with the
# z-loss (1e-4 lse^2 = 0.015), ~12.15; the band keeps +-0.25 around
# [ln(vocab), 12.15], more above, where a hidden state that keeps some of
# its token's embedding would raise the logits' spread.
FIRST_LOSS_BAND = (11.65, 12.7)
# f32 full width, kernels vs plain attention: the loss (~12) within 1e-5 of
# max(1, |loss|), each gradient leaf within 1e-3 of its max |g|
PARITY_LOSS_TOL = 1e-5
PARITY_GRAD_TOL = 1e-3
BWD_INNER = 3         # backward launches per timing at the training shape

API_GRID = 20
API_JOBS = 4
API_DEADLINE_S = 30.0
# The IIs the JAX package's own compile CLI gives for the same cold premap
# (the same flags: the suite on 20x20, fast profile, 4 workers, 30 s
# deadline; run on a CPU host): printed beside the port's, not a gate, since
# the fast profile's wall-clock budgets may settle one II higher under load.
REFERENCE_II_20 = {
    "aes": 14, "backprop": 5, "basicmath": 7, "bitcount": 3, "cfd": 6,
    "crc32": 8, "fft": 7, "gsm": 4, "heartwall": 4, "hotspot3D": 5, "lud": 4,
    "nw": 4, "particlefilter": 9, "sha1": 3, "sha2": 7, "stringsearch": 3,
    "susan": 5,
}
LARGE_PRESET = "mesh_50x50"
LARGE_KERNELS = ("heartwall", "backprop")     # heartwall: BENCH_scale.json's kernel
LANE_CHUNK = 1024      # lanes of the plain version held at once at 50x50
HETERO_PRESET = "satmapit_edge_mem_4x4"

DAEMON_WORKERS = 4
# The daemon's worker threads share one interpreter, so a cold stampede
# time-slices the searches, and the fast profile's wall budget per request
# (20 s) assumes a solve has a core to itself. With z3 as the time backend
# (``auto`` takes it where it is importable, as on the GPU machine) four
# threads at once left hotspot3D and cfd unmapped even with 90 s (PERF.md
# §7). The daemon is therefore started on the incremental CP time backend,
# with this budget per request.
DAEMON_BACKEND = "cp"
DAEMON_BUDGET_S = 90.0
# each of these goes out from DAEMON_DUP_CLIENTS clients at once, the rest
# of the suite from one client each: 26 client threads
DAEMON_DUPLICATED = ("hotspot3D", "backprop", "aes")
DAEMON_DUP_CLIENTS = 4
DAEMON_ROTATE = 8          # worker-run requests per rotated trace segment
DAEMON_START_S = 60.0      # the daemon must answer ping within this
DAEMON_REQUEST_S = 300.0   # a client's socket timeout
# the traced multiply-accumulate against a numpy running sum of a*b in f32
MAC_RTOL = 1e-5
# tests/test_differential.py's fabrics and deterministic mapper budgets
FUZZ_SEEDS = 204
FUZZ_FABRICS = (("mesh3x3", dict(rows=3, cols=3)),
                ("torus4x4", dict(rows=4, cols=4, topology="torus")),
                ("onehop4x4", dict(rows=4, cols=4, topology="one-hop")))
FUZZ_MAP_KW = dict(deterministic=True, use_cache=False, det_space_cap=4000,
                   max_retries_per_window=1, max_slack=1)
FUZZ_BATCH = 4096
FUZZ_ITERS = 32


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


def check_full(name: str, run: dict, chunk: int = FULL_BATCH) -> float:
    """The trace's shape, finiteness, equality with the plain version
    (``chunk`` lanes of it at a time, so that a trace too large to hold
    twice is checked too) and 8 sampled lanes against the oracle. Returns
    max |kernel - plain|."""
    prog, inputs, trace = run["prog"], run["inputs"], run["trace"]
    m = prog.mapping
    C = m.schedule_length + (FULL_ITERS - 1) * m.ii
    check(tuple(trace.shape) == (C, prog.num_pes, FULL_BATCH), f"{name}: trace shape")
    for v, out in run["outs"].items():
        check(tuple(out.shape) == (FULL_ITERS, FULL_BATCH), f"{name}: store {v} shape")
    tables = prog.sim_tables().to("cuda")
    x = stacked(prog, inputs)
    err, same = 0.0, True
    for lo in range(0, FULL_BATCH, chunk):
        part = trace[:, :, lo:lo + chunk]
        # before the plain version exists: isfinite's temporaries are as
        # large as the part, and at 20x20 three traces are held at once
        check(bool(torch.isfinite(part).all()), f"{name}: non-finite trace")
        plain = cgra_sim_torch(tables, x[:, :, lo:lo + chunk].contiguous())
        same = same and torch.equal(part, plain)
        # max |kernel - plain| a few cycles at a time: a whole-trace difference
        # would need as much memory again as the trace
        err = max([err] + [float((part[c:c + 16] - plain[c:c + 16]).abs().max())
                           for c in range(0, C, 16)])
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

def time_ms(fn, runs: int, inner: int = 1) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` after one warm-up;
    each timing spans ``inner`` calls back to back and is divided by it, so
    that a sub-millisecond kernel is not timed with the host's enqueue gap
    before it."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
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

# ------------------------------------------------------------------ phase 6

def flash_cases():
    """(label, (b, hq, hkv, s, d), dtype, options): every case of the JAX
    package's flash sweep (tests/test_kernels_flash.py) in f32 and in bf16,
    so that every option reaches both kernels, then D = 192 and 256, f16, S
    below one tile, a ragged S through the padding path and the serve
    shape."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    sweep = [(f"S{s_len} D{d}", (2, 4, 2, s_len, d), {})
             for s_len in (128, 256, 512) for d in (64, 128)]
    sweep += [(f"GQA {hq}/{hkv}", (1, hq, hkv, 256, 64), {})
              for hq, hkv in ((4, 4), (8, 2), (8, 1))]
    sweep += [(f"window {w}", (1, 2, 2, 256, 64), {"window": w}) for w in (64, 128, 1000)]
    sweep += [(f"softcap {cap:g}", (1, 2, 1, 256, 64), {"softcap": cap})
              for cap in (20.0, 50.0)]
    sweep += [("non-causal", (1, 2, 2, 128, 64), {"causal": False})]
    gemma2 = {"window": 128, "softcap": 50.0}
    sweep += [("gemma2 combination", (2, 8, 4, 512, 128), gemma2)]
    for dtype in (f32, bf16):
        for label, shape, opts in sweep:
            yield f"sweep {label}", shape, dtype, opts
    yield "D256 gemma2", (2, 8, 4, 512, 256), f32, gemma2
    yield "D256 gemma2", (2, 8, 4, 512, 256), bf16, gemma2
    yield "D192", (1, 4, 2, 256, 192), bf16, {}
    yield "D192 window 100", (1, 4, 2, 256, 192), f16, {"window": 100}
    yield "D96 (CUDA cores)", (1, 4, 2, 256, 96), bf16, {}
    yield "f16", (1, 4, 2, 256, 128), f16, {}
    yield "f16 D64", (1, 4, 2, 256, 64), f16, {}
    yield "S48 (one short tile)", (2, 4, 2, 48, 64), bf16, {}
    yield "window 0 (all masked)", (1, 2, 2, 256, 128), bf16, {"window": 0}
    yield "ragged S1000 (padded)", (2, 16, 8, 1000, 128), bf16, {"window": 256, "padded": True}
    yield "serve shape", SERVE_SHAPE, bf16, {}


def tensor_core_path(dtype, d: int) -> bool:
    """Whether flash_attention takes the tensor-core kernel (else the
    CUDA-core one): bf16/f16 at a head dim of whole 64-column boxes."""
    return dtype != torch.float32 and d in (64, 128, 192, 256)


def qkv(shape, dtype, seed: int = 0):
    b, hq, hkv, s_len, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(sh, generator=g, device="cuda").to(dtype)
            for sh in ((b, hq, s_len, d), (b, hkv, s_len, d), (b, hkv, s_len, d))]


def phase_flash() -> float:
    """Each case: the kernel (through its wrapper) against the plain version
    on the same inputs, and the kernel the wrapper chose. Returns the
    largest |kernel - plain| seen."""
    worst = 0.0
    for label, shape, dtype, opts in flash_cases():
        opts = dict(opts)
        q, k, v = qkv(shape, dtype)
        tc_before = flash_attention.tensor_core_launches
        if opts.pop("padded", False):
            got = flash_attention_padded(q, k, v, **opts)
            causal = True
        else:
            got = flash_attention(q, k, v, **opts)
            causal = opts.pop("causal", True)
        torch.cuda.synchronize()
        on_tc = flash_attention.tensor_core_launches - tc_before
        check(on_tc == int(tensor_core_path(dtype, shape[-1])),
              f"flash {label}: {on_tc} tensor-core launches for {dtype} D {shape[-1]}")
        want = flash_attention_torch(q, k, v, causal=causal, **opts)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        err = float((got.float() - want.float()).abs().max())
        ok = (got.dtype == dtype and got.shape == q.shape
              and bool(torch.isfinite(got).all())
              and torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
        check(ok, f"flash {label}: kernel != plain version (max |d| {err:.3g}, tol {tol})")
        if opts.get("window") == 0:
            check(bool((got == 0).all()), f"flash {label}: fully masked rows are not 0")
        worst = max(worst, err)
        path = "tensor cores" if on_tc else "CUDA cores"
        log(f"  ok  {label}: {list(shape)} {str(dtype)[6:]} {opts or ''} [{path}] "
            f"max |kernel - plain| {err:.3g} (tol {tol})")
    return worst


# ------------------------------------------------------------------ phase 7

@contextlib.contextmanager
def captured_attention(layers: tuple) -> dict:
    """The model's flash kernel calls recorded: the dict maps each call
    index in ``layers`` (one call per layer in a forward; remat's
    recomputes come after) to its q, k, v and keywords and, where the
    output takes part in a backward, once that has run, its gradient d
    out."""
    kernel = attention.flash_attention_padded
    seen = {}
    calls = iter(range(10**9))

    def record(q, k, v, **kw):
        i = next(calls)
        out = kernel(q, k, v, **kw)
        if i in layers:
            entry = seen[i] = dict(q=q.detach().clone(), k=k.detach().clone(),
                                   v=v.detach().clone(), kw=kw)
            if out.requires_grad:
                out.register_hook(
                    lambda g, e=entry: e.update(do=g.detach().contiguous().clone()))
        return out

    attention.flash_attention_padded = record
    try:
        yield seen
    finally:
        attention.flash_attention_padded = kernel


@contextlib.contextmanager
def plain_attention():
    """The serving path with the flash kernel's plain version in its place."""
    kernel = attention.flash_attention_padded
    attention.flash_attention_padded = (
        lambda q, k, v, **kw: flash_attention_torch(q, k, v, causal=True, **kw))
    try:
        yield
    finally:
        attention.flash_attention_padded = kernel


def serve_requests(spec, params, queue: list) -> tuple[list, float]:
    """Serve ``queue`` in batches of SERVE_BATCH through ``serve_batch``;
    returns each batch's tokens and the host time (ending in the tokens'
    copy to the host)."""
    out = []
    t0 = time.perf_counter()
    for i in range(0, len(queue), SERVE_BATCH):
        out.append(serve_batch(spec, params, np.stack(queue[i:i + SERVE_BATCH]),
                               SERVE_GEN, SERVE_CACHE_LEN))
    return out, time.perf_counter() - t0


def time_serve_steps(spec, params, prompts: np.ndarray) -> tuple[float, float]:
    """Prefill ms and decode ms per step of one batch (host clock, each
    ending in a synchronise), after the serve run warmed everything."""
    tokens = torch.as_tensor(prompts, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = spec.prefill(params, tokens, SERVE_CACHE_LEN)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits.argmax(-1)[:, None]
    t0 = time.perf_counter()
    for i in range(SERVE_GEN - 1):
        logits, caches = spec.decode_step(params, tok, caches, SERVE_PROMPT + i)
        tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    return prefill_ms, (time.perf_counter() - t0) * 1e3 / (SERVE_GEN - 1)


def profile_serve(spec, params, prompts: np.ndarray) -> None:
    """Where the serving time goes: a torch.profiler window over one prefill,
    then one over 4 decode steps. Prints each window's host time, the
    device's busy share (kernel time over host time) and its top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = {}

    def prefill():
        state["logits"], state["caches"] = spec.prefill(
            params, torch.as_tensor(prompts, device="cuda"), SERVE_CACHE_LEN)

    def decode():
        for i in range(4):
            tok = state["logits"].argmax(-1)[:, None]
            state["logits"], state["caches"] = spec.decode_step(
                params, tok, state["caches"], SERVE_PROMPT + i)

    for label, fn in (("prefill", prefill), ("4 decode steps", decode)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # kernels only: a CPU op's device time is its kernels' time again
        kernels = sorted(((e.self_device_time_total, e.count, e.key)
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and e.self_device_time_total > 0),
                         reverse=True)
        busy_us = sum(k[0] for k in kernels)
        if not busy_us:
            log(f"  profile {label}: device time not measured (no device events)")
            continue
        log(f"  profile {label}: host {wall_us / 1e3:.2f} ms, device busy "
            f"{busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}); top kernels:")
        for us, count, name in kernels[:5]:
            log(f"    {us / 1e3:9.3f} ms {us / busy_us:6.1%} x{count:<5} {name[:70]}")


def teacher_forced_logits(spec, params, prompts: np.ndarray, forced: np.ndarray) -> list:
    """Prefill logits, then each decode step's logits with ``forced`` tokens."""
    logits, caches = spec.prefill(params, torch.as_tensor(prompts, device="cuda"),
                                  SERVE_CACHE_LEN)
    out = [logits]
    for i in range(forced.shape[1]):
        tok = torch.as_tensor(forced[:, i:i + 1], device="cuda")
        logits, caches = spec.decode_step(params, tok, caches, SERVE_PROMPT + i)
        out.append(logits)
    return out


def phase_serve() -> int:
    """Serve the requests, check and time them; returns the flash launches
    of the serving run."""
    cfg = get_config(SERVE_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.vocab, cfg.dtype)
          == (28, 1024, 16, 8, 128, 151936, torch.bfloat16),
          f"{SERVE_ARCH} is not at full width")
    spec = build_model(cfg)
    params = spec.init(0, "cuda")
    rng = np.random.default_rng(0)
    queue = [rng.integers(1, cfg.vocab, size=SERVE_PROMPT)
             for _ in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cgra_sim.launches = 0
    flash_attention.launches = 0
    flash_attention.tensor_core_launches = 0
    batches, serve_s = serve_requests(spec, params, queue)
    launches = flash_attention.launches
    tc_launches = flash_attention.tensor_core_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_batches = len(batches)
    log(f"  {SERVE_ARCH}: {spec.param_count(params) / 1e6:.1f} M params, "
        f"{SERVE_REQUESTS} requests in {n_batches} batches of {SERVE_BATCH}, "
        f"prompt {SERVE_PROMPT}, {SERVE_GEN} generated tokens each")
    log(f"  flash_attention launches on the serving path: {launches}, "
        f"{tc_launches} of them the tensor-core kernel; cgra_sim launches "
        f"there: {cgra_sim.launches}")
    check(launches >= cfg.num_layers * n_batches,
          f"the serving path launched flash_attention {launches} times, "
          f"not >= {cfg.num_layers} per batch")
    check(tc_launches >= cfg.num_layers * n_batches,
          f"the bf16 serving path launched the tensor-core kernel {tc_launches} "
          f"times, not >= {cfg.num_layers} per batch")
    for toks in batches:
        check(toks.shape == (SERVE_BATCH, SERVE_GEN), f"served tokens {toks.shape}")
        check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token out of vocab")
    n_tokens = SERVE_REQUESTS * SERVE_GEN
    prefill_ms, decode_ms = time_serve_steps(spec, params, np.stack(queue[:SERVE_BATCH]))
    log(f"  served {n_tokens} tokens in {serve_s:.3f} s ({n_tokens / serve_s:.1f} tok/s); "
        f"prefill {prefill_ms:.2f} ms per batch of {SERVE_BATCH} x {SERVE_PROMPT}, "
        f"decode {decode_ms:.2f} ms per step; peak device memory {peak_gib:.2f} GiB")

    profile_serve(spec, params, np.stack(queue[:SERVE_BATCH]))

    # the kernel on the activations the bf16 prefill really gives it
    layers = (0, cfg.num_layers - 1)
    with captured_attention(layers) as seen:
        spec.prefill(params, torch.as_tensor(np.stack(queue[:SERVE_BATCH]), device="cuda"),
                     SERVE_CACHE_LEN)
    check(sorted(seen) == list(layers), f"captured layers {sorted(seen)}, not {layers}")
    for layer, e in sorted(seen.items()):
        q, k, v, kw = e["q"], e["k"], e["v"], e["kw"]
        got = flash_attention_padded(q, k, v, **kw)
        want = flash_attention_torch(q, k, v, causal=True, **kw)
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all())
              and torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2),
              f"layer {layer} prefill activations: kernel != plain version "
              f"(max |d| {err:.3g}, tol 2e-2)")
        log(f"  ok  layer {layer} bf16 prefill q/k/v {list(q.shape)}/{list(k.shape)}: "
            f"max |kernel - plain| {err:.3g} (tol 2e-2, |q| max "
            f"{float(q.float().abs().max()):.3g})")
    del seen

    # bf16: the same batch through the plain attention version
    with plain_attention():
        plain_tokens = serve_batch(spec, params, np.stack(queue[:SERVE_BATCH]),
                                   SERVE_GEN, SERVE_CACHE_LEN)
    agree = float((plain_tokens == batches[0]).mean())
    first = float((plain_tokens[:, 0] == batches[0][:, 0]).mean())
    log(f"  bf16 greedy tokens, kernel vs plain attention: {agree:.1%} equal "
        f"({first:.0%} of first tokens); not gated (greedy paths part at near-ties)")

    # f32 at full width: the kernel path against the plain-attention path
    del params
    torch.cuda.empty_cache()
    spec32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    params32 = spec32.init(0, "cuda")
    prompts = np.stack(queue[:SERVE_BATCH])
    forced = batches[0][:, : SERVE_GEN - 1]
    got = teacher_forced_logits(spec32, params32, prompts, forced)
    with plain_attention():
        want = teacher_forced_logits(spec32, params32, prompts, forced)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    for i, (a, b) in enumerate(zip(got, want)):
        what = "prefill" if i == 0 else f"decode step {i}"
        check(a.shape == (SERVE_BATCH, cfg.vocab) and bool(torch.isfinite(a).all()),
              f"f32 {what}: logits {tuple(a.shape)} not finite or misshapen")
        check(torch.allclose(a, b, atol=SERVE_F32_TOL, rtol=SERVE_F32_TOL),
              f"f32 {what}: kernel path != plain-attention path "
              f"(max |d| {errs[i]:.3g}, tol {SERVE_F32_TOL})")
    log(f"  f32 full width, one batch: prefill logits max |d| {errs[0]:.3g}, "
        f"{len(errs) - 1} teacher-forced decode steps max |d| {max(errs[1:]):.3g} "
        f"(tol {SERVE_F32_TOL}, logits max |x| {float(got[0].abs().max()):.3g})")
    return launches


# ------------------------------------------------------------------ phase 8

def flash_bound(shape, itemsize: int) -> tuple[float, str]:
    """Least time for the card at ``shape`` (causal): the FLOPs of the two
    products over the unmasked pairs, over the bf16 tensor-core peak, or
    q, k, v and out read or written once over HBM bandwidth."""
    b, hq, hkv, s_len, d = shape
    flops = 4 * b * hq * d * s_len * (s_len + 1) // 2
    nbytes = 2 * (b * hq + b * hkv) * s_len * d * itemsize
    by_ops = flops / BF16_TENSOR_OPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def phase_flash_timing() -> dict:
    """The kernel at the serve shape in turns with
    ``scaled_dot_product_attention`` (kernel, sdpa, kernel, sdpa), then its
    plain version and the CUDA-core kernel on the same shape in f32."""
    q, k, v = qkv(SERVE_SHAPE, torch.bfloat16, seed=1)
    kernel_ms, library_ms = [], []
    for _ in range(2):
        kernel_ms.append(time_ms(lambda: flash_attention(q, k, v), TIMED_RUNS,
                                 FLASH_INNER))
        library_ms.append(time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), TIMED_RUNS, FLASH_INNER))
    ms = statistics.median(kernel_ms)
    lib_ms = statistics.median(library_ms)
    # one launch between the events, the host's enqueue gap included
    single_ms = time_ms(lambda: flash_attention(q, k, v), TIMED_RUNS)
    plain_ms = time_ms(lambda: flash_attention_torch(q, k, v), 3)
    bound_ms, bound_by = flash_bound(SERVE_SHAPE, q.element_size())
    b, hq, hkv, s_len, d = SERVE_SHAPE
    flops = 4 * b * hq * d * s_len * (s_len + 1) // 2
    log(f"  serve shape {list(SERVE_SHAPE)} bf16 causal, tensor-core kernel: "
        f"{', '.join(f'{t:.4f}' for t in kernel_ms)} ms in turns with "
        f"scaled_dot_product_attention {', '.join(f'{t:.4f}' for t in library_ms)} ms "
        f"(medians of {TIMED_RUNS} x {FLASH_INNER} back to back); plain {plain_ms:.3f} ms; "
        f"bound {bound_ms:.4f} ms "
        f"by {bound_by}, {bound_ms / ms:.1%} of bound, {flops / ms / 1e9:.1f} TFLOP/s; "
        f"one launch alone between the events {single_ms:.4f} ms")
    q32, k32, v32 = (t.float() for t in (q, k, v))
    f32_ms = time_ms(lambda: flash_attention(q32, k32, v32), TIMED_RUNS, FLASH_INNER)
    log(f"  the same shape in f32, CUDA-core kernel: {f32_ms:.4f} ms (median of "
        f"{TIMED_RUNS} x {FLASH_INNER}; its operations over the f32 CUDA-core "
        f"peak {flops / F32_OPS_PER_S * 1e3:.4f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ------------------------------------------------------------------ phase 9

def flash_bwd_cases():
    """Phase 6's cases (the JAX flash sweep in f32 and bf16, D 192/256,
    f16, S 48, window 0, the ragged S through the padding path), then the
    tensor-core backward's head dims and options in bf16 and f16 (GQA
    groups 1, 2 and 4, window, softcap, S below one tile, a ragged S that
    the kernels see unpadded), then the training shape."""
    for label, shape, dtype, opts in flash_cases():
        if label != "serve shape":
            yield label, shape, dtype, opts
    for dtype in (torch.bfloat16, torch.float16):
        for d in (64, 128):
            yield f"GQA 1 D{d}", (2, 4, 4, 256, d), dtype, {}
            yield f"GQA 2 window 100 D{d}", (1, 8, 4, 384, d), dtype, {"window": 100}
            yield f"GQA 4 softcap 30 D{d}", (1, 8, 2, 256, d), dtype, {"softcap": 30.0}
            yield f"S48 window 16 D{d}", (2, 4, 2, 48, d), dtype, {"window": 16}
            yield f"ragged S200 D{d}", (1, 4, 2, 200, d), dtype, {"ragged": True}
    yield "training shape", TRAIN_SHAPE, torch.bfloat16, {}


def tensor_core_bwd_path(dtype, d: int) -> bool:
    """Whether flash_attention_backward takes the tensor-core kernels (else
    the CUDA-core ones): bf16/f16 at D 64 and 128."""
    return dtype != torch.float32 and d in (64, 128)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over want's max |.| (inf if want is 0 and got is not)."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return err / scale if scale else (0.0 if err == 0 else float("inf"))


def grads_of(fn, q, k, v, do):
    """dq, dk, dv of fn(q, k, v) at cotangent do, by autograd."""
    leaves_ = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves_)
    return torch.autograd.grad(out, leaves_, do)


def training_activations() -> list:
    """(label, q, k, v, d out, keywords) of layers 0 and 27 in one bf16
    training step (loss and gradients) of phase 10's model and batch."""
    cfg = get_config(TRAIN_ARCH)
    spec = build_model(cfg)
    params = spec.init(0, "cuda")
    batch = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0).batch_at(0, "cuda")
    layers = (0, cfg.num_layers - 1)
    with captured_attention(layers) as seen:
        loss_and_grads(spec, params, batch)
    check(sorted(seen) == list(layers) and all("do" in e for e in seen.values()),
          f"captured layers {sorted(seen)} (with d out: "
          f"{sorted(i for i, e in seen.items() if 'do' in e)}), not {layers}")
    out = [(f"layer {i} of a bf16 training step", e["q"], e["k"], e["v"], e["do"], e["kw"])
           for i, e in sorted(seen.items())]
    del params, seen
    torch.cuda.empty_cache()
    return out


def check_bwd_case(label: str, q, k, v, do, opts: dict) -> float:
    """The backward (through its wrapper) against its plain version on the
    same q, k, v, output, lse and d out, and against autograd through the
    plain forward; the kernels the wrapper chose; the autograd Function's
    gradients equal the wrapper's; the tensor-core backward gives the same
    bits twice. Returns the largest |kernel - plain|."""
    opts = dict(opts)
    padded = opts.pop("padded", False)
    ragged = opts.pop("ragged", False)       # S no block divides: wrappers only
    dtype, d = q.dtype, q.shape[-1]
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    kw = dict(sm_scale=opts.pop("sm_scale", d ** -0.5), causal=opts.pop("causal", True),
              **opts)
    plain_fwd = lambda a, b_, c: flash_attention_torch(a, b_, c, **kw)  # noqa: E731
    on_tc = tensor_core_bwd_path(dtype, d)
    before = flash_attention.backward_launches
    tc_before = flash_attention.tensor_core_backward_launches
    if padded:
        # the padding path through autograd: F.pad, the Function, slicing
        got = grads_of(lambda a, b_, c: flash_attention_padded(
            a, b_, c, sm_scale=kw["sm_scale"], window=kw.get("window"),
            softcap=kw.get("softcap")), q, k, v, do)
        check(flash_attention.backward_launches == before + 1,
              f"flash bwd {label}: the padded path launched the backward "
              f"{flash_attention.backward_launches - before} times")
        o, lse = flash_attention_torch(q, k, v, return_lse=True, **kw)
        lse_err = 0.0
        launches = 1
    else:
        o, lse = flash_attention_lse(q, k, v, **kw)
        want_o, want_lse = flash_attention_torch(q, k, v, return_lse=True, **kw)
        live = torch.isfinite(want_lse)
        check(torch.equal(torch.isfinite(lse), live),
              f"flash bwd {label}: lse is -inf on other rows than the plain one's")
        lse_err = float((lse[live] - want_lse[live]).abs().max()) if live.any() else 0.0
        check(lse_err <= 1e-3, f"flash bwd {label}: lse off by {lse_err:.3g}")
        got = flash_attention_backward(q, k, v, o, lse, do, **kw)
        check(flash_attention.backward_launches == before + 1,
              f"flash bwd {label}: the backward kernel did not run")
        launches = 1
        if not ragged:
            fn_grads = grads_of(lambda a, b_, c: flash_attention(a, b_, c, **kw),
                                q, k, v, do)
            launches = 2
            check(flash_attention.backward_launches == before + 2,
                  f"flash bwd {label}: the autograd Function did not run the kernel")
            check(all(torch.equal(x, y) for x, y in zip(fn_grads, got)),
                  f"flash bwd {label}: the Function's gradients != the wrapper's")
    on = flash_attention.tensor_core_backward_launches - tc_before
    check(on == launches * on_tc, f"flash bwd {label}: {on} tensor-core backward launches "
          f"of {launches} for {dtype} D {d}")
    if on_tc and not padded:
        again = flash_attention_backward(q, k, v, o, lse, do, **kw)
        check(all(torch.equal(x, y) for x, y in zip(again, got)),
              f"flash bwd {label}: two launches of the tensor-core backward differ")
    torch.cuda.synchronize()
    want = flash_attention_backward_torch(q, k, v, o, lse, do, **kw)
    auto = grads_of(plain_fwd, q, k, v, do)
    errs, auto_errs = [], []
    for name, g, w, a in zip("qkv", got, want, auto):
        check(g.dtype == dtype and g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"flash bwd {label}: d{name} {g.dtype} {list(g.shape)} or not finite")
        errs.append(rel_err(g, w))
        auto_errs.append(rel_err(g, a))
    check(max(errs) <= tol, f"flash bwd {label}: kernel != plain version "
          f"(dq/dk/dv error {', '.join(f'{e:.3g}' for e in errs)} of max |g|, tol {tol})")
    check(max(auto_errs) <= tol, f"flash bwd {label}: kernel != autograd of the plain "
          f"forward ({', '.join(f'{e:.3g}' for e in auto_errs)} of max |g|, tol {tol})")
    if kw.get("window") == 0:
        check(all(bool((g == 0).all()) for g in got),
              f"flash bwd {label}: fully masked rows give non-zero gradients")
    shape = [*q.shape[:2], k.shape[1], *q.shape[2:]]
    log(f"  ok  {label}: {shape} {str(dtype)[6:]} {opts or ''}"
        f"{' [padded]' if padded else ''} [{'tensor cores' if on_tc else 'CUDA cores'}"
        f"{', same bits twice' if on_tc and not padded else ''}] dq/dk/dv vs plain "
        f"{'/'.join(f'{e:.2g}' for e in errs)}, vs autograd "
        f"{'/'.join(f'{e:.2g}' for e in auto_errs)} of max |g| (tol {tol}); "
        f"lse max |d| {lse_err:.2g}")
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def phase_flash_bwd() -> float:
    """Every case of flash_bwd_cases on seeded inputs, then layers 0 and 27
    of a training step. Returns the largest |kernel - plain| seen."""
    worst = 0.0
    for label, shape, dtype, opts in flash_bwd_cases():
        q, k, v = qkv(shape, dtype)
        do = qkv(shape, dtype, seed=1)[0]
        worst = max(worst, check_bwd_case(label, q, k, v, do, opts))
    for label, q, k, v, do, kw in training_activations():
        worst = max(worst, check_bwd_case(label, q, k, v, do, kw))
    return worst


# ----------------------------------------------------------------- phase 10

def loss_and_grads(spec, params, batch):
    flat = [p.detach().clone().requires_grad_() for p in leaves(params)]
    loss, _ = spec.loss_fn(unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(params, grads)


def zero_flash_counts() -> None:
    flash_attention.launches = 0
    flash_attention.tensor_core_launches = 0
    flash_attention.backward_launches = 0
    flash_attention.tensor_core_backward_launches = 0


def flash_counts() -> tuple[int, int, int, int]:
    """Forward, tensor-core forward, backward, tensor-core backward launches."""
    return (flash_attention.launches, flash_attention.tensor_core_launches,
            flash_attention.backward_launches,
            flash_attention.tensor_core_backward_launches)


def train_run(spec, opt_cfg, data, steps: int, *, compression: bool) -> dict:
    """``steps`` of training through make_state / make_step / run_training
    in a fresh checkpoint directory (saved at the last step); returns the
    report, per-step host times, the flash launch counts, peak memory, the
    final state and the save's time. The directory is removed."""
    state = make_state(spec, opt_cfg, 0, compression=compression, device="cuda")
    step = make_step(spec, opt_cfg, compression=compression)
    times, ends = [], []

    def timed(st, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(st, batch)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        times.append(ends[-1] - t0)
        return out

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(dir=build_dir, prefix="chip_smoke_ckpt_")
    try:
        fault = FaultConfig(ckpt_dir=ckpt_dir, ckpt_every=steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_flash_counts()
        state, report = run_training(timed, state,
                                     lambda i: data.batch_at(i, "cuda"), steps, fault)
        done = time.perf_counter()
        counts = flash_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        # the last step's end to the runner's return: the save at the last
        # step (device-to-host snapshot and the npz write)
        save_s = done - ends[-1]
        check(report.restarts == 0, f"training restarted {report.restarts} times: "
              "a step raised (run_training catches and retries)")
        check(report.steps_done == steps, f"{report.steps_done} steps, not {steps}")
        check(all(np.isfinite(report.losses)), f"non-finite losses {report.losses}")
        t0 = time.perf_counter()
        back = restore(ckpt_dir, steps, state)
        restore_s = time.perf_counter() - t0
        for (path, a), (_, b) in zip(leaves_with_paths(back), leaves_with_paths(state)):
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"checkpoint leaf {path} does not restore bit for bit")
        del back
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return dict(report=report, times=times, counts=counts, peak_gib=peak_gib,
                state=state, save_s=save_s, restore_s=restore_s)


def check_counts(counts, steps: int, layers: int, what: str) -> None:
    fwd, tc, bwd, tc_bwd = counts
    need = layers * steps
    check(min(counts) >= need,
          f"{what}: flash launches forward {fwd}, tensor-core {tc}, backward {bwd}, "
          f"tensor-core backward {tc_bwd}; each must be >= {layers} per step ({need})")


def profile_step(spec, opt_cfg, state, batch) -> None:
    """One training step under torch.profiler: host time, the device's busy
    share, the top kernels, and each flash kernel's time and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = make_step(spec, opt_cfg, compression=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new_state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    del new_state
    kernels = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     reverse=True)
    busy_us = sum(k[0] for k in kernels)
    if not busy_us:
        log("  profile of one step: device time not measured (no device events)")
        return
    bwd_us = sum(k[0] for k in kernels if "flash_bwd" in k[2])
    fwd_us = sum(k[0] for k in kernels if "flash_fwd" in k[2])
    log(f"  profile of one step: host {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}); flash backward kernels "
        f"{bwd_us / 1e3:.3f} ms ({bwd_us / busy_us:.1%} of busy), flash forward "
        f"{fwd_us / 1e3:.3f} ms ({fwd_us / busy_us:.1%}); top kernels:")
    for us, count, name in kernels[:8]:
        log(f"    {us / 1e3:9.3f} ms {us / busy_us:6.1%} x{count:<5} {name[:70]}")
    log("  flash kernels of the step: " + "; ".join(
        f"{name.split('(')[0].removeprefix('void ')} {us / 1e3:.3f} ms x{count}"
        for us, count, name in kernels if "flash_" in name))


def phase_train() -> int:
    """Train, check and time; returns the backward launches of the 8-step
    run."""
    cfg = get_config(TRAIN_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.dtype, cfg.remat)
          == (28, 1024, 16, 8, 128, 3072, 151936, torch.bfloat16, True),
          f"{TRAIN_ARCH} is not at full width with remat")
    spec = build_model(cfg)
    # the training CLI's defaults for this many steps
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                          warmup_steps=max(10, TRAIN_STEPS // 20))
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    run = train_run(spec, opt_cfg, data, TRAIN_STEPS, compression=False)
    report, times = run["report"], run["times"]
    check_counts(run["counts"], TRAIN_STEPS, cfg.num_layers, "training")
    lo, hi = FIRST_LOSS_BAND
    check(lo <= report.losses[0] <= hi,
          f"first loss {report.losses[0]:.4f} outside [{lo}, {hi}] (ln vocab "
          f"{np.log(cfg.vocab):.4f})")
    ms = statistics.median(times[TRAIN_TIMED_FROM:]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fwd, tc, bwd, tc_bwd = run["counts"]
    log(f"  {TRAIN_ARCH}: {spec.param_count(run['state']['params']) / 1e6:.1f} M params, "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, bf16, remat; restarts "
        f"{report.restarts}")
    log(f"  losses {', '.join(f'{x:.4f}' for x in report.losses)} (ln vocab "
        f"{np.log(cfg.vocab):.4f})")
    log(f"  flash launches over the run: forward {fwd} ({fwd / TRAIN_STEPS:g} a step), "
        f"tensor-core {tc}, backward {bwd} ({bwd / TRAIN_STEPS:g} a step), tensor-core "
        f"backward {tc_bwd}")
    log(f"  step times {', '.join(f'{t * 1e3:.1f}' for t in times)} ms; median of steps "
        f"{TRAIN_TIMED_FROM + 1}-{TRAIN_STEPS} {ms:.2f} ms/step, {tokens / ms * 1e3:.0f} "
        f"tokens/s; peak device memory {run['peak_gib']:.2f} GiB; checkpoint save at the "
        f"last step {run['save_s']:.2f} s, restore {run['restore_s']:.2f} s (bit for bit)")
    bwd_launches = bwd

    profile_step(spec, opt_cfg, run["state"], data.batch_at(TRAIN_STEPS, "cuda"))
    del run
    torch.cuda.empty_cache()

    run = train_run(spec, opt_cfg, data, COMPRESSION_STEPS, compression=True)
    check_counts(run["counts"], COMPRESSION_STEPS, cfg.num_layers, "compressed training")
    log(f"  --grad-compression: {COMPRESSION_STEPS} steps, losses "
        f"{', '.join(f'{x:.4f}' for x in run['report'].losses)}, restarts "
        f"{run['report'].restarts}, peak device memory {run['peak_gib']:.2f} GiB, step "
        f"times {', '.join(f'{t * 1e3:.1f}' for t in run['times'])} ms")
    del run
    torch.cuda.empty_cache()

    # f32 at full width, batch 1 x 2048: kernels against plain attention
    spec32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    params32 = spec32.init(0, "cuda")
    batch = SyntheticLM(cfg, 1, TRAIN_SEQ, seed=1).batch_at(0, "cuda")
    zero_flash_counts()
    loss, grads = loss_and_grads(spec32, params32, batch)
    fwd, tc, bwd, tc_bwd = flash_counts()
    check((fwd, tc, bwd, tc_bwd) == (2 * cfg.num_layers, 0, cfg.num_layers, 0),
          f"f32 step: forward {fwd}, tensor-core {tc}, backward {bwd}, tensor-core "
          f"backward {tc_bwd} launches; expected {2 * cfg.num_layers}, 0, "
          f"{cfg.num_layers}, 0")
    with plain_attention():
        plain_loss, plain = loss_and_grads(spec32, params32, batch)
    check(flash_counts() == (fwd, tc, bwd, tc_bwd),
          "the plain-attention step launched a kernel")
    loss_err = abs(float(loss) - float(plain_loss))
    check(loss_err <= PARITY_LOSS_TOL * max(1.0, abs(float(plain_loss))),
          f"f32 loss {float(loss):.7f} vs plain attention {float(plain_loss):.7f}")
    worst, worst_path = 0.0, ""
    for (path, g), (_, w) in zip(leaves_with_paths(grads), leaves_with_paths(plain)):
        err = rel_err(g, w)
        check(err <= PARITY_GRAD_TOL, f"f32 gradient {path}: {err:.3g} of its max |g| "
              f"(tol {PARITY_GRAD_TOL})")
        if err > worst:
            worst, worst_path = err, path
    log(f"  f32 full width, batch 1 x {TRAIN_SEQ}: loss {float(loss):.7f} vs plain "
        f"attention {float(plain_loss):.7f} (|d| {loss_err:.3g}); gradients of "
        f"{len(leaves(grads))} leaves within {worst:.3g} of each leaf's max |g| (worst "
        f"{worst_path}; tol {PARITY_GRAD_TOL}); {bwd} backward launches")
    return bwd_launches


# ----------------------------------------------------------------- phase 11

def flash_bwd_bound(shape, itemsize: int) -> tuple[float, str]:
    """Least time for the card at ``shape`` (causal): the five products of
    the backward (2.5x the forward's FLOPs) over the bf16 tensor-core peak,
    or q, k, v, o, d out and lse read and dq, dk, dv written once over HBM
    bandwidth."""
    b, hq, hkv, s_len, d = shape
    flops = 10 * b * hq * d * s_len * (s_len + 1) // 2
    nbytes = (4 * b * hq + 4 * b * hkv) * s_len * d * itemsize + b * hq * s_len * 4
    by_ops = flops / BF16_TENSOR_OPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def phase_flash_bwd_timing() -> dict:
    """The tensor-core backward at the training shape in turns with the
    backward of ``scaled_dot_product_attention`` through autograd (kernel,
    sdpa, kernel, sdpa), then its plain version and the CUDA-core backward
    on the same shape in f32."""
    q, k, v = qkv(TRAIN_SHAPE, torch.bfloat16, seed=2)
    do = qkv(TRAIN_SHAPE, torch.bfloat16, seed=3)[0]
    kw = dict(sm_scale=TRAIN_SHAPE[-1] ** -0.5)
    o, lse = flash_attention_lse(q, k, v, **kw)
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    tc_before = flash_attention.tensor_core_backward_launches
    kernel_ms, library_ms = [], []
    for _ in range(2):
        kernel_ms.append(time_ms(lambda: flash_attention_backward(q, k, v, o, lse, do, **kw),
                                 TIMED_RUNS, BWD_INNER))
        library_ms.append(time_ms(lambda: torch.autograd.grad(
            sdpa_out, (ql, kl, vl), do, retain_graph=True), TIMED_RUNS, BWD_INNER))
    check(flash_attention.tensor_core_backward_launches - tc_before
          == 2 * (1 + TIMED_RUNS * BWD_INNER), "the timed backward is not the tensor-core one")
    ms = statistics.median(kernel_ms)
    lib_ms = statistics.median(library_ms)
    plain_ms = time_ms(lambda: flash_attention_backward_torch(q, k, v, o, lse, do, **kw), 3)
    bound_ms, bound_by = flash_bwd_bound(TRAIN_SHAPE, q.element_size())
    b, hq, hkv, s_len, d = TRAIN_SHAPE
    flops = 10 * b * hq * d * s_len * (s_len + 1) // 2
    log(f"  training shape {list(TRAIN_SHAPE)} bf16 causal, tensor-core backward: "
        f"{', '.join(f'{t:.4f}' for t in kernel_ms)} ms in turns with the backward of "
        f"scaled_dot_product_attention {', '.join(f'{t:.4f}' for t in library_ms)} ms "
        f"(medians of {TIMED_RUNS} x {BWD_INNER} back to back); plain {plain_ms:.3f} ms; "
        f"bound {bound_ms:.4f} ms by {bound_by} ({flops:.3g} FLOP), {bound_ms / ms:.1%} of "
        f"bound, {flops / ms / 1e9:.1f} TFLOP/s of the bound's FLOP, "
        f"{1.4 * flops / ms / 1e9:.1f} of the 7 products done")
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    o32, lse32 = flash_attention_lse(q32, k32, v32, **kw)
    f32_ms = time_ms(lambda: flash_attention_backward(q32, k32, v32, o32, lse32, do32, **kw),
                     3)
    log(f"  the same shape in f32, CUDA-core backward: {f32_ms:.4f} ms (median of 3; its "
        f"FLOP over the f32 CUDA-core peak {flops / F32_OPS_PER_S * 1e3:.4f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# ----------------------------------------------------------------- phase 12

def cache_entries(root: Path) -> dict:
    """The persistent cache's entries by DFG hash: (ii, t_abs, placement,
    routes) as the cold run wrote them (one entry per kernel)."""
    entries = {}
    for path in sorted(root.rglob("*.json")):
        e = json.loads(path.read_text())
        check(e["key"][0] not in entries, f"two cache entries for {e['key'][0]}")
        entries[e["key"][0]] = (e["ii"], e["t_abs"], e["placement"],
                                [tuple(r) for r in e["routes"]])
    return entries


def run_mapping(name: str, mapping, map_s: float) -> tuple[dict, dict]:
    """Lower ``mapping``, execute it through ``cgra_run`` at full size and
    hold the trace against the plain version and the oracle (phase 4's
    check); the trace is freed before the next one. Returns the input
    streams and the store streams, on the host."""
    prog = compile_program(mapping)
    inputs = seeded_inputs(prog, FULL_ITERS, FULL_BATCH, seed=1)
    outs, trace = cgra_run(prog, inputs, FULL_ITERS, device="cuda")
    torch.cuda.synchronize()
    check_full(name, dict(prog=prog, inputs=inputs, outs=outs, trace=trace,
                          map_s=map_s))
    stores = {v: out.cpu().numpy() for v, out in outs.items()}
    del outs, trace
    torch.cuda.empty_cache()
    return inputs, stores


def phase_api(smi: str) -> tuple[int, dict]:
    """The compiler API path (see the module docstring, item 12). Returns
    cgra_sim's launches over the phase's executions and heartwall's 50x50
    timing row."""
    t_phase = time.perf_counter()
    suite = load_suite()
    names = list(suite)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    (ROOT / "build").mkdir(exist_ok=True)
    cache_dir = Path(tempfile.mkdtemp(prefix="api-cache-", dir=ROOT / "build"))
    report_path = cache_dir.with_name(cache_dir.name + "-report.json")
    cgra_sim.launches = 0
    try:
        # 1. cold premap through the CLI, in a process that never touches CUDA
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.compile", "--suite",
             "--size", str(API_GRID), "--profile", "fast", "--jobs", str(API_JOBS),
             "--deadline-s", str(API_DEADLINE_S), "--cache-dir", str(cache_dir),
             "--report", str(report_path), "--quiet"],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
        cold_s = time.perf_counter() - t0
        check(out.returncode == 0, f"compile CLI exited {out.returncode}: {out.stderr[-2000:]}")
        report = json.loads(report_path.read_text())
        rows = {j["name"]: j for j in report["jobs"]}
        check(sorted(rows) == sorted(names) and report["ok"], "cold premap: a kernel failed")
        check(report["num_workers"] == API_JOBS, f"cold premap ran {report['num_workers']} workers")
        check(report["cache"]["solved"] == len(names), f"cold premap: {report['cache']}")
        log(f"  cold premap (python -m repro_torch.compile, {API_JOBS} workers): "
            f"{len(names)} kernels on {API_GRID}x{API_GRID} in {cold_s:.2f} s "
            f"(report wall {report['wall_s']} s)")
        log("    II port/reference: " + ", ".join(
            f"{n} {rows[n]['ii']}/{REFERENCE_II_20[n]}" for n in names))
        entries = cache_entries(cache_dir)
        check(len(entries) == len(names), f"{len(entries)} cache entries, not {len(names)}")

        # 2. warm session in process: every kernel a disk hit, nothing solved
        clear_mapping_cache()
        t0 = time.perf_counter()
        comp = Compiler(CGRA(API_GRID, API_GRID),
                        resolve_options("fast", cache_dir=str(cache_dir)))
        warm = comp.compile_batch(list(suite.values()))
        warm_s = time.perf_counter() - t0
        c = warm.cache_counters
        check(warm.ok and c["disk_hits"] == len(names) and c["solved"] == 0
              and c["failed"] == 0, f"warm session: {c}")
        check(warm.num_workers > 1, "warm session fell back to one process")
        for r in warm:
            m = r.mapping
            got = (m.ii, m.t_abs, m.placement, [tuple(x) for x in m.routes_spec()])
            check(r.source == "disk", f"{r.name}: served from {r.source}")
            check(got == entries[suite[r.name].stable_hash()]
                  and m.ii == rows[r.name]["ii"], f"{r.name}: warm mapping != cold")
        log(f"  warm session (Compiler.compile_batch, {warm.num_workers} workers): "
            f"{c['disk_hits']} disk hits, {c['solved']} solved in {warm_s:.2f} s; "
            f"every mapping equals the cold run's")

        # 3. execute every warm mapping at full size
        for r in warm:
            run_mapping(r.name, r.mapping, rows[r.name]["wall_s"])

        # 4. the annealing engine on 2500 PEs
        big = Compiler(LARGE_PRESET, resolve_options("fast"))
        large = {}
        for name in LARGE_KERNELS:
            res = big.compile(suite[name])
            check(res.ok, f"{name} on {LARGE_PRESET}: {res.reason}")
            check(res.space_backend == "anneal",
                  f"{name} on {LARGE_PRESET}: placed by {res.space_backend}")
            check(res.mapping.validate() == [], f"{name}: invalid 50x50 mapping")
            check_equivalence(res.mapping)
            prog = compile_program(res.mapping)
            inputs = seeded_inputs(prog, FULL_ITERS, FULL_BATCH, seed=1)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            outs, trace = cgra_run(prog, inputs, FULL_ITERS, device="cuda")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            err = check_full(f"{name} ({LARGE_PRESET}, {res.space_backend})",
                             dict(prog=prog, inputs=inputs, outs=outs, trace=trace,
                                  map_s=res.wall_s), chunk=LANE_CHUNK)
            log(f"      trace {trace.numel() * 4 / 1e9:.1f} GB checked in lane chunks "
                f"of {LANE_CHUNK} (max |d| {err}); peak device memory "
                f"{peak / 2**30:.2f} GiB")
            large[name] = (prog, inputs)
            del outs, trace
            torch.cuda.empty_cache()

        # 5. the heterogeneous preset
        hetero = Compiler(HETERO_PRESET, resolve_options(
            "fast", jobs=API_JOBS, deadline_s=API_DEADLINE_S))
        t0 = time.perf_counter()
        batch = hetero.compile_batch(list(suite.values()))
        hetero_s = time.perf_counter() - t0
        failed = [r.name for r in batch if not r.ok]
        check(not failed, f"{HETERO_PRESET}: not mapped: {failed}")
        check(batch.num_workers == API_JOBS, f"{HETERO_PRESET}: {batch.num_workers} workers")
        log(f"  {HETERO_PRESET}: {len(batch)} kernels mapped in {hetero_s:.2f} s "
            f"({batch.num_workers} workers); II " +
            ", ".join(f"{r.name} {r.ii}" for r in batch))
        for r in batch:
            cgra = hetero.cgra
            check(all(cgra.capable(r.mapping.placement[v], op_class(r.mapping.dfg.ops[v]))
                      for v in r.mapping.dfg.nodes), f"{r.name}: op on an incapable PE")
            run_mapping(f"{r.name} ({HETERO_PRESET})", r.mapping, r.wall_s)
        launches = cgra_sim.launches          # read before any timing launch
        want = 2 * len(names) + len(LARGE_KERNELS)
        check(launches == want, f"phase 12 launched cgra_sim {launches} times, not {want}")

        # heartwall's kernel and its zero-fill alone, as phase 5 times them
        prog, inputs = large[LARGE_KERNELS[0]]
        tables = prog.sim_tables().to("cuda")
        x = stacked(prog, inputs)
        shape = (tables.num_cycles(FULL_ITERS), prog.num_pes, FULL_BATCH)
        ms = time_ms(lambda: cgra_sim(tables, x), TIMED_RUNS)
        fill_ms = time_ms(lambda: torch.zeros(shape, device="cuda"), TIMED_RUNS)
        bound_ms, bound_by, nbytes = bound(prog, tables, x)
        log(f"  {LARGE_KERNELS[0]} {LARGE_PRESET} on {smi}: kernel {ms:.4f} ms "
            f"(median of {TIMED_RUNS}, zero-fill included; the fill alone "
            f"{fill_ms:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B), "
            f"{bound_ms / ms:.1%} of bound")
        large_row = dict(ms=ms, fill_ms=fill_ms, bound_ms=bound_ms, bound_by=bound_by)
        del large, tables, x
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        report_path.unlink(missing_ok=True)

    # 6. the example users start from, on the card
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"quickstart_torch.py exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    check("cgra_sim on cuda" in out.stdout, "quickstart_torch.py did not run on the card")
    log(f"  examples/quickstart_torch.py: exit 0 ({out.stdout.strip().splitlines()[-1]})")
    log(f"  cgra_sim launches in phase 12: {launches}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, large_row


# ----------------------------------------------------------------- phase 13

def mac_body(ins, carried):
    """tests/test_frontend.py's multiply-accumulate loop."""
    acc = carried["acc"] + ins[0] * ins[1]
    return [acc], {"acc": acc}


def mixed_body(ins, carried):
    """tests/test_frontend.py's mixed-op body with constants."""
    x = (ins[0] + 2.0) * ins[1] - 1.0
    y = abs(-x).min(100.0)
    return [y], {}


def all_ops_body(ins, carried):
    """Every operator ``Var`` overloads (the bitwise ops, shifts, compare,
    ``min``/``max``, the reflected ones), with a carried accumulator; every
    divisor is at least 1, so the streams stay finite."""
    a, b, c = ins
    s = a + b
    d = 1.5 - a
    e = 2.0 + b
    f = 3.0 * c
    h = (s * d) / (abs(e) + 1.0)
    i = (s & 255.0) | (b ^ c)
    j = (i << 2.0) >> (a - 1.0)
    k = -(~j)
    n = k.min(h).max(f > h)
    acc = carried["acc"] + n - f
    return [acc, j], {"acc": acc}


FRONTEND_BODIES = (("mac", mac_body, 2, ["acc"]), ("mixed", mixed_body, 2, []),
                   ("all_ops", all_ops_body, 3, ["acc"]))


def same_values(a, b) -> bool:
    """``torch.equal`` that also takes NaN for NaN: random programs may
    overflow, and the trace holds what the ALU gives there."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def run_fuzz_case(label: str, mapping, seed: int) -> int:
    """Execute one fuzz mapping through ``cgra_run`` at FUZZ_BATCH x
    FUZZ_ITERS: the trace equals the plain version and up to 8 sampled lanes
    the oracle (NaN for NaN). A program without an input stream runs one
    lane, as ``cgra_run`` defines it. Returns the lanes run."""
    prog = compile_program(mapping)
    inputs = seeded_inputs(prog, FUZZ_ITERS, FUZZ_BATCH, seed=seed)
    _, trace = cgra_run(prog, inputs, FUZZ_ITERS, device="cuda")
    batch = trace.shape[2]
    check(tuple(trace.shape) == (prog.mapping.schedule_length + (FUZZ_ITERS - 1) * prog.ii,
                                 prog.num_pes, FUZZ_BATCH if inputs else 1),
          f"{label}: trace shape {tuple(trace.shape)}")
    tables = prog.sim_tables().to("cuda")
    x = (stacked(prog, inputs) if inputs
         else torch.zeros((0, FUZZ_ITERS, 1), device="cuda"))
    check(same_values(trace, cgra_sim_torch(tables, x)), f"{label}: kernel != plain version")
    lanes = np.random.default_rng(seed).choice(batch, min(SAMPLED_LANES, batch),
                                               replace=False)
    _, ref = cgra_sim_reference(prog, inputs, FUZZ_ITERS, lanes=lanes if inputs else None)
    got = trace[:, :, torch.as_tensor(lanes, device="cuda")].cpu().numpy()
    check(np.array_equal(got, ref, equal_nan=True), f"{label}: sampled lanes != oracle")
    return batch


def wait_for_daemon(proc, sock: str) -> float:
    """Poll ``DaemonClient.ping`` until the daemon answers; fails when the
    deadline passes or the process exits. Returns the seconds it took."""
    t0 = time.perf_counter()
    while True:
        check(proc.poll() is None, f"daemon exited {proc.returncode} before answering")
        try:
            with DaemonClient(sock, timeout_s=5) as c:
                if c.ping():
                    return time.perf_counter() - t0
        except DaemonError:
            pass
        check(time.perf_counter() - t0 < DAEMON_START_S,
              f"daemon did not answer ping within {DAEMON_START_S} s")
        time.sleep(0.1)


def daemon_requests(names: list) -> list:
    """The suite once, and each of DAEMON_DUPLICATED from DAEMON_DUP_CLIENTS
    clients: one request per client thread."""
    return [n for n in names if n not in DAEMON_DUPLICATED] + [
        n for n in DAEMON_DUPLICATED for _ in range(DAEMON_DUP_CLIENTS)]


def phase_daemon() -> int:
    """The daemon, frontend, fuzz and placement paths (see the module
    docstring, item 13). Returns cgra_sim's launches over the phase."""
    t_phase = time.perf_counter()
    suite = load_suite()
    names = list(suite)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="daemon-", dir=ROOT / "build"))
    cache_dir, trace_dir = work / "cache", work / "traces"
    # AF_UNIX paths hold at most 107 bytes: the socket lives in a short
    # temporary directory, not under a checkout that may lie deep
    sock_dir = tempfile.mkdtemp(prefix="rtd-")
    if len(sock_dir) > 80:
        shutil.rmtree(sock_dir)
        sock_dir = tempfile.mkdtemp(prefix="rtd-", dir="/tmp")
    sock = os.path.join(sock_dir, "d.sock")
    log_path = work / "serve.log"
    proc = None
    cgra_sim.launches = 0
    try:
        # (a) the daemon, started as its user starts it: a fresh process,
        # so no CUDA state is forked
        with open(log_path, "w") as serve_log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.daemon", "serve", "--socket", sock,
                 "--rows", str(API_GRID), "--cols", str(API_GRID), "--profile", "fast",
                 "--backend", DAEMON_BACKEND, "--time-budget-s", str(DAEMON_BUDGET_S),
                 "--workers", str(DAEMON_WORKERS), "--cache-dir", str(cache_dir),
                 "--trace-dir", str(trace_dir), "--rotate-every", str(DAEMON_ROTATE)],
                env=env, cwd=ROOT, stdout=serve_log, stderr=subprocess.STDOUT)
        up_s = wait_for_daemon(proc, sock)
        requests = daemon_requests(names)
        gate = threading.Barrier(len(requests))

        def one(name):
            with DaemonClient(sock, timeout_s=DAEMON_REQUEST_S) as c:
                gate.wait(timeout=60)            # every client sends at once
                return name, c.compile(suite[name], tenant=f"client-{name}")

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as pool:
            rows = list(pool.map(one, requests))
        cold_s = time.perf_counter() - t0
        bad = [(n, r["failure"], r["reason"]) for n, r in rows if not r["ok"]]
        check(not bad, f"daemon rows failed: {bad}")
        ii, solve_s = {}, {}
        for n, r in rows:
            check(ii.setdefault(n, r["ii"]) == r["ii"], f"{n}: duplicates differ in II")
            solve_s[n] = r["wall_s"]
        with DaemonClient(sock) as c:
            stats = c.stats()
        st = {k: stats[k] for k in ("submitted", "completed", "shed", "failed",
                                    "coalesced", "cancelled_in_queue", "solves",
                                    "warm_memory", "warm_disk")}
        log(f"  daemon (python -m repro_torch.daemon serve, {DAEMON_WORKERS} workers, "
            f"{API_GRID}x{API_GRID}, fast): up in {up_s:.2f} s; {len(requests)} requests "
            f"from {len(requests)} clients at once ({len(DAEMON_DUPLICATED)} kernels x "
            f"{DAEMON_DUP_CLIENTS}) in {cold_s:.2f} s; {st}")
        log(f"    speculation (not gated): {stats['speculative']}")
        # completed counts the requests a worker ran: a coalesced follower
        # receives its leader's row and is never counted as completed
        # (server.py: coalesced at admission, completed in
        # _record_completion), so completed + coalesced == submitted
        check(st["submitted"] == len(requests), f"daemon stats: {st}")
        check(st["completed"] + st["coalesced"] == st["submitted"]
              and st["shed"] == 0 and st["failed"] == 0 and st["cancelled_in_queue"] == 0,
              f"daemon stats: {st}")
        check(st["solves"] + st["warm_memory"] + st["warm_disk"] + st["coalesced"]
              == st["submitted"], f"daemon stats do not account for every request: {st}")
        check(st["solves"] <= len(names), f"daemon solved {st['solves']} times "
              f"for {len(names)} kernels")
        log("    II: " + ", ".join(f"{n} {ii[n]}" for n in names) + "; time backend "
            + ", ".join(sorted({r["backend"] for _, r in rows})))
        with DaemonClient(sock) as c:
            check(c.shutdown(), "daemon refused shutdown")
        rc = proc.wait(timeout=60)
        check(rc == 0, f"daemon exited {rc}: {log_path.read_text()[-2000:]}")
        check(not os.path.exists(sock), "the daemon left its socket behind")
        segments = sorted(trace_dir.glob("trace-*.json"))
        check(len(segments) >= 2, f"{len(segments)} trace segments rotated")
        for seg in segments:
            out = subprocess.run(
                [sys.executable, str(ROOT / "tools" / "trace_report.py"), str(seg), "--check"],
                capture_output=True, text=True, timeout=120)
            check(out.returncode == 0, f"trace_report {seg.name}: {out.stdout}{out.stderr}")
        spans = sum(len(json.loads(seg.read_text())["traceEvents"]) for seg in segments)
        log(f"    shutdown: exit 0, socket removed; tools/trace_report.py --check read "
            f"{len(segments)} rotated segments ({spans} events)")

        # the daemon's cache serves a warm in-process session
        clear_mapping_cache()
        t0 = time.perf_counter()
        comp = Compiler(CGRA(API_GRID, API_GRID),
                        resolve_options("fast", cache_dir=str(cache_dir)))
        warm = comp.compile_batch(list(suite.values()))
        warm_s = time.perf_counter() - t0
        c = warm.cache_counters
        check(warm.ok and c["disk_hits"] == len(names) and c["solved"] == 0
              and c["failed"] == 0, f"warm session on the daemon's cache: {c}")
        for r in warm:
            check(r.source == "disk" and r.ii == ii[r.name],
                  f"{r.name}: warm {r.source} II {r.ii}, daemon II {ii[r.name]}")
        log(f"    warm Compiler session on the daemon's cache: {c['disk_hits']} disk "
            f"hits, {c['solved']} solved in {warm_s:.2f} s; IIs equal the daemon's")
        for r in warm:
            check_equivalence(r.mapping)
            run_mapping(f"{r.name} (daemon)", r.mapping, solve_s[r.name])

        # (b) the tracing frontend
        for label, body, num_inputs, carried in FRONTEND_BODIES:
            dfg = trace_loop(body, num_inputs=num_inputs, carried=carried, name=label)
            t0 = time.perf_counter()
            res = map_dfg(dfg, CGRA(*FULL_GRID), time_budget_s=30)
            check(res.ok, f"traced {label} on {FULL_GRID}: {res.reason}")
            check_equivalence(res.mapping)
            inputs, stores = run_mapping(f"traced {label}", res.mapping,
                                         time.perf_counter() - t0)
            if label == "mac":
                a, b = sorted(inputs)
                want = np.cumsum(inputs[a] * inputs[b], axis=0, dtype=np.float32)
                (got,) = stores.values()
                err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
                check(np.allclose(got, want, rtol=MAC_RTOL, atol=0),
                      f"traced mac != running sum of a*b (max rel {err})")
                log(f"      mac stores == numpy running sum of a*b over all "
                    f"{FULL_BATCH} lanes (max rel err {err}, tolerance {MAC_RTOL})")

        # (c) the fuzz generator as a correctness harness for the kernel
        t0 = time.perf_counter()
        before = cgra_sim.launches
        mapped, lanes_run, map_s = 0, 0, 0.0
        for fabric, kw in FUZZ_FABRICS:
            cgra = CGRA(**kw)
            for seed in range(FUZZ_SEEDS):
                label = f"fuzz seed={seed} fabric={fabric}"
                t1 = time.perf_counter()
                res = map_dfg(random_dfg(seed), cgra, space_backend="exact", **FUZZ_MAP_KW)
                map_s += time.perf_counter() - t1
                if not res.ok:
                    continue
                check(res.mapping.validate() == [], f"{label}: invalid mapping")
                check_equivalence(res.mapping)
                lanes_run += run_fuzz_case(label, res.mapping, seed)
                mapped += 1
        fuzz_s = time.perf_counter() - t0
        cases = FUZZ_SEEDS * len(FUZZ_FABRICS)
        launches = cgra_sim.launches
        log(f"  fuzz: random_dfg seeds 0-{FUZZ_SEEDS - 1} on "
            f"{', '.join(f for f, _ in FUZZ_FABRICS)} (exact, deterministic): {mapped} of "
            f"{cases} cases mapped ({map_s:.1f} s on the host), each run at "
            f"{FUZZ_BATCH} x {FUZZ_ITERS} ({lanes_run} lanes in all; "
            f"{launches - before} cgra_sim launches) == plain == oracle in {fuzz_s:.1f} s")
        want = len(names) + len(FRONTEND_BODIES) + mapped
        check(launches == want, f"phase 13 launched cgra_sim {launches} times, not {want}")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(sock_dir, ignore_errors=True)

    # (d) the placement example's twin
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "pipeline_placement_torch.py")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"pipeline_placement_torch.py exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    check(out.stdout.count("single-hop flows 100%") == 5,
          "pipeline_placement_torch.py: a placement is not all single-hop")
    log(f"  examples/pipeline_placement_torch.py: exit 0 "
        f"({out.stdout.strip().splitlines()[-1][:100]}...)")
    log(f"  cgra_sim launches in phase 13: {launches}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


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
    with ThreadPoolExecutor(len(KERNELS)) as pool:      # one nvcc per source
        libs = list(pool.map(lambda name: _build.build(name, verbose=True), KERNELS))
    log(f"[2] build: {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s")

    log("[3] small programs: kernel vs plain version, oracle and interpreter")
    phase_small()

    log(f"[4] main path: {', '.join(FULL_KERNELS)} on {FULL_GRID[0]}x{FULL_GRID[1]}, "
        f"B={FULL_BATCH}, num_iters={FULL_ITERS}")
    suite = load_suite(list(FULL_KERNELS))
    torch.cuda.reset_peak_memory_stats()
    cgra_sim.launches = 0
    flash_attention.launches = 0
    flash_attention.tensor_core_launches = 0
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
    del runs, rows
    torch.cuda.empty_cache()

    log("[6] flash_attention kernel vs its plain version")
    flash_err = phase_flash()

    log(f"[7] serving path: {SERVE_ARCH} at full width, {SERVE_REQUESTS} requests, "
        f"batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_GEN} generated tokens")
    flash_launches = phase_serve()

    log(f"[8] flash_attention timing on {smi}")
    flash_row = phase_flash_timing()

    log("[9] flash_attention backward kernels vs their plain version and autograd")
    bwd_err = phase_flash_bwd()

    log(f"[10] training path: {TRAIN_ARCH} at full width, {TRAIN_STEPS} steps of "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, then {COMPRESSION_STEPS} with compression")
    bwd_launches = phase_train()

    log(f"[11] flash_attention backward timing on {smi}")
    bwd_row = phase_flash_bwd_timing()

    log(f"[12] compiler API path: the suite premapped on {API_GRID}x{API_GRID}, "
        f"warm session, {LARGE_PRESET} (anneal), {HETERO_PRESET}; "
        f"B={FULL_BATCH}, num_iters={FULL_ITERS}")
    api_launches, _ = phase_api(smi)

    log(f"[13] compile daemon, tracing frontend, fuzz generator and stage placement: "
        f"the suite through python -m repro_torch.daemon on {API_GRID}x{API_GRID}, "
        f"three traced loops, random_dfg seeds 0-{FUZZ_SEEDS - 1} on "
        f"{len(FUZZ_FABRICS)} fabrics, examples/pipeline_placement_torch.py")
    daemon_launches = phase_daemon()

    print(json.dumps({"kernels": [{
        "name": "cgra_sim",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cgra_sim.cu",
        "replaces": "src/repro/kernels/cgra_sim.py:75",
        "launches": launches + api_launches + daemon_launches,
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": flash_launches,
        "max_abs_err": flash_err,
        "ms": flash_row["ms"],
        "plain_ms": flash_row["plain_ms"],
        "bound_ms": flash_row["bound_ms"],
        "bound_by": flash_row["bound_by"],
        "library_ms": flash_row["library_ms"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": bwd_launches,
        "max_abs_err": bwd_err,
        "ms": bwd_row["ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
