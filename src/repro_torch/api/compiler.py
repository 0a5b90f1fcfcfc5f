"""The :class:`Compiler` session: one target + one options value, reused.

A ``Compiler`` binds ``(ArchSpec | CGRA, CompileOptions, caches)`` once and
routes every compile through the existing mapper/service internals
(DESIGN.md §11.2): :meth:`Compiler.compile` is the in-process portfolio
mapper, :meth:`Compiler.compile_batch` fans a workload across the process
pool (``core/service/batch.compile_many``), and :meth:`Compiler.compile_racing`
stripes one hard problem's (II, slack) windows across workers. All three
return the unified :class:`~repro_torch.api.result.CompileResult` schema.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time as _time
from typing import Callable, Iterable, Sequence

from .. import obs
from ..core.arch import ArchSpec, resolve_arch
from ..core.cgra import CGRA
from ..core.dfg import DFG
from ..core.mapper import _map_dfg_impl
from ..core.service.batch import CompileJob, compile_many, map_dfg_racing
from ..core.service.cache import DiskMappingCache, resolve_cache_dir
from .options import CompileOptions, resolve_options
from .result import BatchResult, CompileResult

__all__ = ["Compiler"]


def _resolve_target(target) -> tuple[ArchSpec | None, CGRA]:
    """Normalise a target into (spec | None, cgra).

    Accepts a :class:`CGRA` (spec is None), an :class:`ArchSpec`, or a string
    (preset name / ArchSpec JSON path, via ``resolve_arch``) — the same
    resolution every CLI's ``--arch`` flag uses.
    """
    if isinstance(target, CGRA):
        return None, target
    if isinstance(target, ArchSpec):
        return target, target.cgra()
    if isinstance(target, str):
        spec = resolve_arch(target)
        return spec, spec.cgra()
    raise TypeError(
        f"target must be a CGRA, ArchSpec, or preset/path string, "
        f"got {type(target).__name__}"
    )


class Compiler:
    """A compilation session bound to one target machine and one policy.

    Example — a deterministic session over the SAT-MapIt-style preset::

        from repro_torch.api import Compiler, resolve_options
        from repro_torch.core import running_example

        comp = Compiler("satmapit_edge_mem_4x4",
                        resolve_options("deterministic-ci"))
        res = comp.compile(running_example())
        assert res.ok and res.mapping.validate() == []
        batch = comp.compile_batch([running_example()])
        assert batch.ok and batch.results[0].ii == res.ii

    Parameters:

    * ``target`` — a :class:`~repro_torch.core.cgra.CGRA`, an
      :class:`~repro_torch.core.arch.ArchSpec`, or a preset-name/JSON-path string;
      ``None`` falls back to ``options.arch`` (one of the two must name a
      machine).
    * ``options`` — a :class:`~repro_torch.api.options.CompileOptions`, a profile
      name, or ``None`` (profile defaults); extra ``**overrides`` are applied
      on top via :func:`~repro_torch.api.options.resolve_options` semantics.

    The session's persistent cache handle is exposed as :attr:`cache`
    (``None`` when no cache directory is configured) for pre-warming and
    inspection; compiles share its files through the content-addressed store
    (DESIGN.md §9).
    """

    def __init__(self, target=None, options=None, **overrides) -> None:
        if isinstance(options, str):
            options = resolve_options(options)
        elif options is None:
            options = resolve_options()
        elif not isinstance(options, CompileOptions):
            raise TypeError(
                f"options must be CompileOptions, a profile name, or None, "
                f"got {type(options).__name__}"
            )
        if overrides:
            options = options.replace(**overrides)
        options.validate()
        if target is None:
            if options.arch is None:
                raise ValueError(
                    "no target machine: pass target= or set options.arch"
                )
            target = options.arch
        self.spec, self.cgra = _resolve_target(target)
        self.options = options
        self._cache: DiskMappingCache | None = None
        if options.use_cache:
            root = resolve_cache_dir(options.cache_dir)
            if root is not None:
                self._cache = DiskMappingCache(root)

    # ------------------------------------------------------------- properties
    @property
    def cache(self) -> DiskMappingCache | None:
        """The session's persistent mapping-cache handle (or None).

        One stable object per session — compiles running in this process or
        in pool workers share its *files* (content-addressed, DESIGN.md §9)
        while its ``stats`` count only operations made through this handle.
        """
        return self._cache

    def validate_workload(self, dfgs: Iterable[DFG]) -> list[str]:
        """Feasibility problems of a workload against this target (empty =
        every op class has a capable PE); mirrors ``ArchSpec.validate_for``."""
        return sorted({p for d in dfgs for p in self.cgra.unsupported_ops(d)})

    def _opts(self, overrides: dict) -> CompileOptions:
        if not overrides:
            return self.options
        opts = self.options.replace(**overrides)
        opts.validate()
        return opts

    # --------------------------------------------------------- certification
    def _certify(self, dfg: DFG, result: CompileResult,
                 opts: CompileOptions) -> None:
        """Exact-check post-pass (DESIGN.md §14.4): attach a certificate to
        a successful result, adopting the joint backend's mapping when it
        strictly beats the portfolio's II.

        Adopted mappings are written into both mapping-cache layers under
        the portfolio's own key, so the next compile of this kernel serves
        the certified-optimal II instead of re-discovering it (skipped in
        deterministic mode, where the mapper bypasses caches entirely).
        """
        if not result.ok or result.mapping is None:
            return
        from ..core.exact_backends import certify_mapping
        from ..core.mapper import cache_store_mapping

        t0 = _time.perf_counter()
        with obs.span("certify", kernel=dfg.name, ii=result.ii) as sp:
            cert, better = certify_mapping(
                dfg, self.cgra, result.mapping,
                connectivity=opts.connectivity,
                max_route_hops=opts.max_route_hops,
                max_register_pressure=opts.max_register_pressure,
                budget_s=opts.exact_budget_s,
                deterministic=opts.deterministic,
            )
            sp.set(ii_opt=cert.ii_opt, adopted=better is not None)
        if better is not None:
            result.mapping = better
            result.ii = better.ii
            result.route_movs = better.num_route_movs
            result.space_backend = "joint"
            if opts.use_cache and not opts.deterministic:
                cache_store_mapping(
                    dfg, self.cgra, better,
                    connectivity=opts.connectivity,
                    max_register_pressure=opts.max_register_pressure,
                    max_route_hops=opts.max_route_hops,
                    space_backend=opts.space_backend,
                    cache_dir=opts.cache_dir,
                )
        result.ii_opt = cert.ii_opt
        result.certificate = cert.as_dict()
        # book the certification post-pass as its own phase (§14.4 / §15.3):
        # without this, certify wall time silently inflates nothing — it was
        # simply unaccounted — so total_s under-reported the compile
        dt = _time.perf_counter() - t0
        result.phases = dataclasses.replace(
            result.phases,
            exact_s=result.phases.exact_s + dt,
            total_s=result.phases.total_s + dt,
        )
        result.wall_s += dt
        result.metrics["phases"] = result.phases.as_dict()

    # --------------------------------------------------------------- compile
    def compile(
        self,
        dfg: DFG,
        *,
        should_stop: Callable[[], bool] | None = None,
        **overrides,
    ) -> CompileResult:
        """Map one DFG in-process through the portfolio mapper.

        ``should_stop`` is the cooperative-cancellation hook forwarded to the
        mapper; ``**overrides`` are per-call option changes (e.g.
        ``time_budget_s=5``) that do not mutate the session.
        """
        opts = self._opts(overrides)
        with obs.span("compile", kernel=dfg.name) as sp:
            res = _map_dfg_impl(
                dfg, self.cgra, should_stop=should_stop,
                **opts.mapper_kwargs()
            )
            result = CompileResult.from_map_result(res, name=dfg.name)
            if opts.exact_check:
                self._certify(dfg, result, opts)
            sp.set(ok=result.ok, ii=result.ii)
        return result

    def compile_batch(
        self,
        dfgs: Sequence[DFG],
        *,
        names: Sequence[str] | None = None,
        cancel=None,
        **overrides,
    ) -> BatchResult:
        """Map a workload across the process pool (DESIGN.md §8.1).

        ``options.jobs`` picks the worker count (None = all cores; 1 =
        sequential in-process, the deterministic-CI mode), ``options.
        deadline_s`` the per-job wall budget, and ``cancel`` an Event-like
        object for cooperative cancellation. Rows come back in input order.
        """
        opts = self._opts(overrides)
        if names is not None and len(names) != len(dfgs):
            raise ValueError(
                f"names has {len(names)} entries for {len(dfgs)} DFGs"
            )
        names = names or [d.name for d in dfgs]
        batch = [
            CompileJob(dfg, self.cgra, name=name)
            for dfg, name in zip(dfgs, names)
        ]
        t0 = _time.perf_counter()
        # cross-process span shards (DESIGN.md §15.2): pool workers append
        # per-pid shard files into a scratch dir that we merge back into this
        # process's tracer; the inline path (jobs<=1) records directly into
        # the active tracer and writes no shards
        tracer = obs.get_tracer()
        trace_tmp = (tempfile.TemporaryDirectory(prefix="repro-spans-")
                     if tracer is not None else None)
        try:
            report = compile_many(
                batch,
                jobs=opts.jobs,
                deterministic=opts.deterministic,
                cache_dir=opts.cache_dir,
                use_cache=opts.use_cache,
                cancel=cancel,
                map_options=opts.batch_kwargs(),
                trace_dir=trace_tmp.name if trace_tmp is not None else None,
            )
        finally:
            if trace_tmp is not None:
                events, counters = obs.merge_shards(trace_tmp.name)
                tracer.adopt(events)
                for key, n in counters.items():
                    tracer.counters[key] = tracer.counters.get(key, 0) + n
                trace_tmp.cleanup()
        result = BatchResult.from_report(
            report, pairs=[(job.dfg, job.cgra) for job in batch],
            max_register_pressure=opts.max_register_pressure,
        )
        if opts.exact_check:
            # certification is a caller-side post-pass (sequential, in
            # process): worker rows stay lean and the sweep sees the exact
            # reconstructed mapping every row was re-validated with
            for job, row in zip(batch, result.results):
                self._certify(job.dfg, row, opts)
        result.wall_s = _time.perf_counter() - t0
        return result

    def compile_racing(
        self,
        dfg: DFG,
        *,
        workers: int | None = None,
        **overrides,
    ) -> CompileResult:
        """Race one mapping's (II, slack) windows across workers (§8.2).

        ``workers`` defaults to ``options.racing_workers``; deterministic
        sessions fall back to the plain in-process compile (a wall-clock race
        cannot honor the reproducibility contract).
        """
        opts = self._opts(overrides)
        res = map_dfg_racing(
            dfg,
            self.cgra,
            workers=workers if workers is not None else opts.racing_workers,
            **opts.mapper_kwargs(exclude=("window_offset", "window_stride")),
        )
        return CompileResult.from_map_result(
            res, name=dfg.name, wall_s=res.stats.total_s
        )

    def __repr__(self) -> str:  # pragma: no cover
        tgt = self.spec.name if self.spec is not None else str(self.cgra)
        prof = self.options.profile or "custom"
        return f"Compiler(target={tgt}, options={prof})"
