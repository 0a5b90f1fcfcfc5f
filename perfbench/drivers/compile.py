"""Compile cells: the mapper does most of the work.

The window runs whole passes. A pass submits the configuration's DFGs cold
to ``repro_torch.core.service.compile_many`` (the traffic's ``jobs``
workers, the configuration's options, no mapping cache), then lowers every
mapping that comes back with ``kernels/ops.py::compile_program`` and runs it
once through ``cgra_run`` over the traffic's streams, its stores copied to
the host. A pass that cannot end in the window is not started: the next
pass starts only while the time left holds the longest pass so far. The
seed sets only the streams; the DFGs and the mapper's own seed are fixed.

End-to-end metrics: ``suite_compile_s``, the window over its passes, and
``ii_over_mii``, the geometric mean over every kernel mapped in the window
of its II over the mII that ``legality.min_ii`` works out. The check: every
kernel mapped, cold, by the configuration's time backend, every mapping
legal by ``legality.violations``, and every store of every execution equal
to ``reference.interpret``'s.

Forked workers and CUDA: ``compile_many`` forks its workers from this
process after CUDA is initialised. The workers run the mapper alone
(``core/mapper.py`` and its backends, pure Python and z3) and never call
into torch.cuda, which a forked child could not use.
"""

from __future__ import annotations

import math
import os
import time

from .. import executor, legality, suite, trace
from ..inputs import StreamPool

#: JobReport fields a pass keeps for the check and the metric readers.
ROW_FIELDS = ("name", "ok", "ii", "backend", "cache_hit", "disk_cache_hit", "reason",
              "t_abs", "placement", "time_phase_s", "space_phase_s", "windows_opened",
              "space_nodes_visited")


def geomean(xs: list[float]) -> float:
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        traffic = ctx.cell["traffic"]
        if traffic.get("order", "suite") != "suite":
            raise ValueError(f"compile cells submit the suite in order, not {traffic['order']!r}")
        self.workers = traffic["jobs"]
        self.streams = traffic["streams"]
        self.iters = traffic["iterations"]
        self.attempted = self.failed = 0
        self.passes: list[dict] = []
        self.record: dict = {"workers": self.workers}
        self.notes: list[str] = []

    def setup(self) -> None:
        from repro_torch.core.mapper import map_dfg
        from repro_torch.core.service import CompileJob
        from repro_torch.core.time_backends import available_backends, resolve_backend_name

        cfg = self.ctx.config
        self.opts = suite.compile_options(cfg)
        if self.opts.use_cache:
            raise ValueError(f"{cfg['name']}: compile cells compile cold; use_cache must be false")
        self.backend = resolve_backend_name(self.opts.backend)
        if not available_backends().get(self.backend):
            raise RuntimeError(f"the time backend {self.backend!r} that {cfg['name']} "
                               "states is not importable")
        self.dfgs = suite.port_dfgs(cfg)
        self.plain = suite.plain_dfgs(cfg)
        self.cgra = suite.port_cgra(cfg)
        self.mesh = suite.mesh(cfg)
        self.mii = {k: legality.min_ii(d, self.mesh) for k, d in self.plain.items()}
        self.jobs = [CompileJob(d, self.cgra, name=k) for k, d in self.dfgs.items()]
        self.pool = StreamPool(self.ctx.seed, self.iters, self.streams)
        self.trace_dir = None
        if self.ctx.trace:
            self.trace_dir = os.path.join(self.ctx.scratch, "obs")
            os.makedirs(self.trace_dir)
        # the time backend and the mapper loaded here, so that the workers
        # fork with them
        small = min(self.dfgs.values(), key=lambda d: d.num_nodes)
        map_dfg(small, self.cgra, **self.opts.mapper_kwargs())
        # the executor at the window's sizes: the frozen mappings of the suite
        for k, dfg in self.dfgs.items():
            m = suite.load_frozen_mapping(cfg["name"], k)
            prog = executor.lower(suite.port_mapping(dfg, self.cgra, m["ii"], m["t_abs"],
                                                     m["placement"]))
            executor.run_batch(self.ctx, prog, self.pool.streams(prog.input_nodes(), "warm", k),
                               self.iters)

    def _pass(self, index: int) -> dict:
        from repro_torch.core.service import compile_many

        t0 = time.perf_counter()
        with self.ctx.span("compile_many"):
            report = compile_many(self.jobs, jobs=self.workers, use_cache=False,
                                  map_options=self.opts, trace_dir=self.trace_dir)
        compile_s = time.perf_counter() - t0
        rows = []
        for job in report.jobs:
            row = {k: getattr(job, k) for k in ROW_FIELDS}
            if job.ok:
                try:
                    with self.ctx.span("compile_program"):
                        prog = executor.lower(suite.port_mapping(
                            self.dfgs[job.name], self.cgra, job.ii, job.t_abs, job.placement))
                    streams = self.pool.streams(prog.input_nodes(), "pass", index, job.name)
                    row["stores"] = executor.run_batch(self.ctx, prog, streams, self.iters)
                except (AssertionError, ValueError, IndexError) as exc:
                    row["error"] = f"{type(exc).__name__}: {exc}"
            rows.append(row)
        return {"compile_s": compile_s, "wall_s": time.perf_counter() - t0, "jobs": rows}

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while (not self.passes or time.perf_counter() - t0
               + max(p["wall_s"] for p in self.passes) <= seconds):
            self.passes.append(self._pass(len(self.passes)))
        window_s = time.perf_counter() - t0
        self.record["passes"] = self.passes
        out = {"suite_compile_s": window_s / len(self.passes)}
        ratios = [row["ii"] / self.mii[row["name"]]
                  for p in self.passes for row in p["jobs"] if row["ok"]]
        if ratios:
            out["ii_over_mii"] = geomean(ratios)
        self.notes.append(
            f"{len(self.passes)} passes in {window_s:.3f} s (compile "
            + ", ".join(f"{p['compile_s']:.3f}" for p in self.passes) + " s); II/mII "
            + ", ".join(f"{r['name']} {r['ii']}/{self.mii[r['name']]}"
                        for r in self.passes[0]["jobs"] if r["ok"]))
        return out

    def release(self) -> None:
        executor.free_device(self.ctx)
        if self.trace_dir:
            from repro_torch import obs

            events, _ = obs.merge_shards(self.trace_dir)
            self.record["obs_events"] = events
            _, self_us, count = trace.self_times(events)
            top = sorted(self_us.items(), key=lambda kv: -kv[1])[:6]
            self.notes.append("workers' self time by span, s per pass: " + ", ".join(
                f"{name} {us / 1e6 / len(self.passes):.3f} ({count[name]})" for name, us in top))

    def _same_backend(self, name: str) -> bool:
        from repro_torch.core.time_backends import resolve_backend_name

        try:
            return resolve_backend_name(name) == self.backend
        except ValueError:
            return False

    def verify(self) -> dict:
        counts = dict.fromkeys(("unmapped", "cache_hits", "other_time_backend",
                                "illegal_mappings", "store_mismatches"), 0)
        for index, p in enumerate(self.passes):
            names = [row["name"] for row in p["jobs"]]
            missing = set(self.dfgs) - set(names)
            if missing or len(names) != len(set(names)):
                self.notes.append(f"pass {index}: {len(names)} results, none for "
                                  f"{sorted(missing)}")
            counts["unmapped"] += len(missing) + len(names) - len(set(names))
            self.attempted += len(self.dfgs)
            self.failed += len(missing)
            for row in p["jobs"]:
                bad = bool(row["cache_hit"] or row["disk_cache_hit"])
                counts["cache_hits"] += bad
                if not row["ok"]:
                    counts["unmapped"] += 1
                    self.failed += 1
                    self.notes.append(f"pass {index} {row['name']}: not mapped: {row['reason']}")
                    continue
                if not self._same_backend(row["backend"]):
                    counts["other_time_backend"] += 1
                    bad = True
                plain = self.plain[row["name"]]
                errs = legality.violations(plain, self.mesh, row["ii"], row["t_abs"],
                                           row["placement"])
                if errs:
                    counts["illegal_mappings"] += 1
                    bad = True
                    self.notes.append(f"pass {index} {row['name']}: illegal: {errs[:3]}")
                if "error" in row:
                    self.notes.append(f"pass {index} {row['name']}: {row['error']}")
                streams = self.pool.streams(plain.inputs(), "pass", index, row["name"])
                n = executor.store_mismatches(plain, streams, row.get("stores"), self.iters)
                counts["store_mismatches"] += n
                bad = bad or n > 0
                self.failed += bad
        return {k: (v, 0) for k, v in counts.items()}
