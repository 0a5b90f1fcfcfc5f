"""Exec cells: the mapper is bypassed, and the executor does the work.

Set-up loads the configuration's frozen mappings (``data/mappings/``),
holds each to the legality checker, lowers each with
``kernels/ops.py::compile_program`` and runs each once. The window calls
``cgra_run`` with host (numpy) streams of the traffic's size, round robin
over the kernels in the configuration's order, and copies each batch's
stores to the host; it ends when the batch running at ``--seconds`` has its
stores on the host.

End-to-end metric: ``exec_rate``, every stream-iteration of every batch over
the window, in 1e9 a second. The check: a sample drawn from the seed of
``checked_per_kernel`` batches of each kernel (a reservoir over all its
batches of the window), every store equal to ``reference.interpret``'s.
"""

from __future__ import annotations

import time

import numpy as np

from .. import executor, legality, suite
from ..inputs import StreamPool, seed_words
from ..roofline import executor_bound


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        traffic = ctx.cell["traffic"]
        if traffic.get("order", "round_robin") != "round_robin":
            raise ValueError(f"exec cells go round robin, not {traffic['order']!r}")
        self.streams = traffic["streams"]
        self.iters = traffic["iterations"]
        self.keep = traffic["checked_per_kernel"]
        self.attempted = self.failed = 0
        self.record: dict = {}
        self.notes: list[str] = []

    def setup(self) -> None:
        cfg = self.ctx.config
        self.plain = suite.plain_dfgs(cfg)
        dfgs = suite.port_dfgs(cfg)
        cgra = suite.port_cgra(cfg)
        self.mesh = suite.mesh(cfg)
        self.kernels = list(cfg["kernels"])
        self.illegal = 0
        self.programs = []
        for k in self.kernels:
            m = suite.load_frozen_mapping(cfg["name"], k)
            errs = legality.violations(self.plain[k], self.mesh, m["ii"], m["t_abs"],
                                       m["placement"])
            if errs:
                self.illegal += 1
                self.notes.append(f"frozen mapping {k}: illegal: {errs[:3]}")
            self.programs.append(executor.lower(
                suite.port_mapping(dfgs[k], cgra, m["ii"], m["t_abs"], m["placement"])))
        self.inputs = [p.input_nodes() for p in self.programs]
        self.pool = StreamPool(self.ctx.seed, self.iters, self.streams)
        for k, prog, nodes in zip(self.kernels, self.programs, self.inputs):
            executor.run_batch(self.ctx, prog, self.pool.streams(nodes, "warm", k), self.iters)
        self.bound_s = []
        for k, prog, nodes in zip(self.kernels, self.programs, self.inputs):
            m = prog.mapping
            self.bound_s.append(executor_bound(
                num_cycles=m.schedule_length + (self.iters - 1) * m.ii,
                num_pes=prog.num_pes, batch=self.streams, num_iters=self.iters,
                num_inputs=len(nodes), num_nodes=self.plain[k].num_nodes, ii=m.ii)[0])
        self.rng = np.random.default_rng(seed_words(self.ctx.seed, "sample"))

    def window(self, seconds: float) -> dict:
        n = len(self.programs)
        kept: list[list] = [[] for _ in range(n)]
        seen = [0] * n
        i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            k = i % n
            stores = executor.run_batch(
                self.ctx, self.programs[k], self.pool.streams(self.inputs[k], "batch", i),
                self.iters)
            seen[k] += 1
            if len(kept[k]) < self.keep:
                kept[k].append((i, stores))
            else:
                j = int(self.rng.integers(0, seen[k]))
                if j < self.keep:
                    kept[k][j] = (i, stores)
            i += 1
            if time.perf_counter() >= deadline:
                break
        window_s = time.perf_counter() - t0
        self.batches, self.kept = i, kept
        self.record.update(batches=i, bound_s=sum(c * b for c, b in zip(seen, self.bound_s)))
        self.notes.append(f"{i} batches in {window_s:.3f} s")
        return {"exec_rate": i * self.streams * self.iters / window_s / 1e9}

    def release(self) -> None:
        executor.free_device(self.ctx)

    def verify(self) -> dict:
        self.attempted = self.batches
        mismatched = 0
        for k, kept in enumerate(self.kept):
            plain = self.plain[self.kernels[k]]
            for i, stores in kept:
                streams = self.pool.streams(self.inputs[k], "batch", i)
                n = executor.store_mismatches(plain, streams, stores, self.iters)
                mismatched += n
                self.failed += n > 0
        return {"illegal_mappings": (self.illegal, 0), "store_mismatches": (mismatched, 0)}
