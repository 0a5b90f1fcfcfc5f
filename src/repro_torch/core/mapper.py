"""End-to-end space/time-decoupled CGRA mapper (paper §IV) with a portfolio
search layer (DESIGN.md §6).

Pipeline per II (starting at mII = max(ResII, RecII)):

  1. TIME  — backend search over the KMS window for a schedule satisfying the
     modulo-scheduling + capacity + connectivity constraints (time_smt.py).
  2. SPACE — monomorphism search embedding the labelled DFG into the MRRG
     (mono.py).
  3. If the space search fails (possible: the published constraints are
     necessary but not sufficient, see DESIGN.md §7), the time solution is
     excluded — the incremental backends never re-propose a label partition —
     and step 1 re-runs.

The portfolio layer replaces the old strictly-sequential (II, slack) sweep:
all candidate windows are visited in rounds of geometrically growing budgets
(time-solver steps, space-search nodes, restarts). Round r spends little
enough per window that infeasible low IIs cannot starve feasible higher ones
— the failure mode that made 20x20 grids take tens of seconds — while windows
that merely need a deeper dive get it on the next round, preserving the
smallest-II-first quality preference. Time solutions whose partitions failed
to embed are kept and retried with bigger space budgets/new seeds in later
rounds before fresh partitions are enumerated (time work is never repeated),
and finished mappings land in a small LRU cache keyed on (DFG content hash,
CGRA dims, II) so repeated compilations of the same kernel are free. A
persistent on-disk layer under the LRU (``cache_dir`` / $REPRO_CACHE_DIR,
service/cache.py, DESIGN.md §9) extends that reuse across processes and
restarts, and the service layer (service/batch.py, DESIGN.md §8) fans the
mapper out across worker processes — per batch via ``compile_many`` and per
job via (II, slack) window striping (``window_offset``/``window_stride``).

``deterministic=True`` replaces every wall-clock budget with visited-node /
solver-step budgets: identical inputs then take the identical search path
regardless of machine load (used by tests; see DESIGN.md §6.3).
"""

from __future__ import annotations

import time as _time
from collections import OrderedDict
from dataclasses import dataclass, field

from .. import obs
from .cgra import CGRA
from .dfg import DFG, Route, splice_routes
from .mono import SpaceStats, check_monomorphism, check_routes, find_monomorphism
from .space_backends import (
    SpaceBudget,
    create_space_backend,
    resolve_space_backend_name,
)
from .schedule import min_ii, rec_ii, res_ii
from .time_backends import resolve_backend_name
from .time_smt import TimeSolution, TimeSolver, check_time_solution


@dataclass
class Mapping:
    """A complete space-time mapping of a DFG onto a CGRA.

    When the space engine had to route edges through intermediate PEs
    (``max_route_hops > 0``, DESIGN.md §12), ``dfg`` is the *rewritten* graph
    — original node ids unchanged, one appended ``mov`` node per hop — and
    ``routes`` carries the provenance, so consumers can still report
    placements of the original kernel (``original_nodes`` /
    ``original_placement``). A direct mapping has ``routes == []``.
    """

    dfg: DFG
    cgra: CGRA
    ii: int
    t_abs: list[int]                 # absolute schedule time per node
    placement: list[int]             # PE per node
    routes: list[Route] = field(default_factory=list)  # route-through provenance

    @property
    def labels(self) -> list[int]:
        return [t % self.ii for t in self.t_abs]

    @property
    def folds(self) -> list[int]:
        return [t // self.ii for t in self.t_abs]

    @property
    def schedule_length(self) -> int:
        return max(self.t_abs) + 1

    @property
    def num_stages(self) -> int:
        """Pipeline depth: number of interleaved iterations in steady state."""
        return -(-self.schedule_length // self.ii)

    @property
    def num_route_movs(self) -> int:
        """Route-through movs appended to the DFG (0 for direct mappings)."""
        return sum(len(r.movs) for r in self.routes)

    @property
    def original_nodes(self) -> range:
        """Node ids of the pre-rewrite kernel (splicing appends, never renames)."""
        return range(self.dfg.num_nodes - self.num_route_movs)

    def original_placement(self) -> list[int]:
        """Placement restricted to the original kernel's nodes."""
        return list(self.placement[: len(self.original_nodes)])

    def routes_spec(self) -> tuple[tuple[int, int, int, int], ...]:
        """Compact ``(src, dst, distance, n_movs)`` rows — what both mapping
        caches persist; ``dfg.splice_routes`` rebuilds the rewritten DFG."""
        return tuple(r.spec() for r in self.routes)

    def kernel_table(self) -> list[list[tuple[int, int]]]:
        """Per kernel step: [(pe, node)] executing at that step."""
        rows: list[list[tuple[int, int]]] = [[] for _ in range(self.ii)]
        for v in self.dfg.nodes:
            rows[self.labels[v]].append((self.placement[v], v))
        for r in rows:
            r.sort()
        return rows

    def validate(
        self, *, connectivity: str = "paper", registers: bool = True
    ) -> list[str]:
        """All violated constraints of this mapping (empty = valid).

        ``registers=True`` (the default) additionally runs the simulator's
        register-pressure probe and reports a violation when the steady-state
        live-value count on any PE exceeds that PE's register bound
        (``cgra.registers_at(pe)`` — per-capability-class when the arch
        declares ``registers_by_class``, the scalar ``registers_per_pe``
        otherwise; paper §V-3). The mapper itself validates with
        ``registers=False``: it only *guarantees* the bound when asked via
        ``max_register_pressure``, and a caller probing an already-found
        mapping should see the violation, not a crash.
        """
        errs = check_time_solution(
            self.dfg, self.cgra, TimeSolution(self.ii, self.t_abs),
            connectivity=connectivity,
        )
        errs += check_monomorphism(
            self.dfg, self.cgra, self.labels, self.placement, self.ii
        )
        if self.routes:
            errs += check_routes(
                self.dfg, self.cgra, self.t_abs, self.placement, self.ii,
                self.routes,
            )
        if registers and not errs:
            # simulate imports this module for Mapping: import lazily
            from .simulate import register_pressure_by_pe

            for pe, pressure in sorted(register_pressure_by_pe(self).items()):
                bound = self.cgra.registers_at(pe)
                if pressure > bound:
                    errs.append(
                        f"register pressure {pressure} > {bound} on PE {pe}"
                    )
        return errs

    def pretty(self) -> str:
        lines = [
            f"mapping of {self.dfg.name!r} on {self.cgra.rows}x{self.cgra.cols} "
            f"CGRA: II={self.ii}, schedule length={self.schedule_length}, "
            f"stages={self.num_stages}"
        ]
        for step, row in enumerate(self.kernel_table()):
            cells = " ".join(
                f"PE{pe}<-n{v}(it{self.folds[v]})" for pe, v in row
            )
            lines.append(f"  t%II={step}: {cells}")
        return "\n".join(lines)


@dataclass
class MapperStats:
    time_phase_s: float = 0.0
    space_phase_s: float = 0.0
    validate_s: float = 0.0          # independent re-validation of mappings
    total_s: float = 0.0
    time_solutions_tried: int = 0
    mono_failures: int = 0
    final_ii: int = -1
    m_ii: int = -1
    res_ii: int = -1
    rec_ii: int = -1
    backend: str = ""
    space_backend: str = ""          # concrete engine that placed the result
    rounds: int = 0
    windows_opened: int = 0          # (II, slack) windows that got a solver
    cache_hit: bool = False          # served from the in-process LRU
    disk_cache_hit: bool = False     # served from the persistent disk cache
    space_nodes_visited: int = 0
    # ---- observability counters (DESIGN.md §15.3): per-compile solver and
    # cache-layer telemetry mirrored into JobReport/CompileResult.metrics
    time_steps: int = 0              # cumulative time-backend search steps
    space_restarts: int = 0          # space-engine restarts across all probes
    mem_cache_lookups: int = 0       # in-process LRU consultations (0 or 1)
    mem_cache_hits: int = 0
    disk_cache_lookups: int = 0      # persistent-layer consultations (0 or 1)
    disk_cache_hits: int = 0
    disk_cache_promotions: int = 0   # disk hits promoted into the LRU


@dataclass
class MapResult:
    mapping: Mapping | None
    stats: MapperStats
    reason: str = ""

    @property
    def ok(self) -> bool:
        return self.mapping is not None


# --------------------------------------------------------------- LRU cache

# (dfg_hash, rows, cols, topology, connectivity, max_rp, arch_token,
#  pressure_token, max_route_hops, ii) -> (t_abs, placement, routes_spec)
_MAP_CACHE: OrderedDict[
    tuple, tuple[list[int], list[int], tuple]
] = OrderedDict()
_MAP_CACHE_MAX = 128


@dataclass
class MemoryCacheStats:
    """Hit/miss counters for the in-process LRU mapping cache.

    The symmetric twin of ``service.cache.CacheStats`` — process-wide, reset
    together with the cache by :func:`clear_mapping_cache`, and surfaced
    per compile through ``CompileResult.metrics`` (DESIGN.md §15.3).
    """

    hits: int = 0
    misses: int = 0
    writes: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float | None:
        n = self.hits + self.misses
        return round(self.hits / n, 6) if n else None

    def as_dict(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "writes": self.writes,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }


_MEM_CACHE_STATS = MemoryCacheStats()


def memory_cache_stats() -> MemoryCacheStats:
    """The process-wide LRU counters (live object, not a snapshot)."""
    return _MEM_CACHE_STATS


def clear_mapping_cache() -> None:
    global _MEM_CACHE_STATS
    _MAP_CACHE.clear()
    _MEM_CACHE_STATS = MemoryCacheStats()


def _cache_base_key(
    dfg, cgra, connectivity, max_rp, max_route_hops=0, space_backend="exact",
) -> tuple:
    # arch_token is None on the paper's homogeneous grid and a digest of the
    # capability layout otherwise (DESIGN.md §10) — heterogeneous mappings of
    # the same DFG must never alias homogeneous ones in either cache layer.
    # pressure_token keys the *effective per-PE* register bounds the mapper
    # guarantees under max_rp (scalar-only keying served oversubscribing
    # mappings across register sizings), and max_route_hops keys the route-
    # through allowance — a hops=2 mapping carries movs a hops=0 caller must
    # never be served. space_backend is the *resolved* engine name ("auto"
    # never reaches a key): exact and anneal explore different mapping
    # distributions, so entries must not alias across engines (DESIGN.md §13.4).
    return (
        dfg.stable_hash(), cgra.rows, cgra.cols, cgra.topology,
        connectivity, max_rp, cgra.arch_token(),
        cgra.pressure_token(max_rp), max_route_hops, space_backend,
    )


def _rebuild_mapping(
    dfg: DFG, cgra: CGRA, ii: int, t_abs: list[int], placement: list[int],
    routes_spec,
) -> Mapping:
    """Reconstruct a (possibly routed) Mapping from cached arrays.

    Raises ValueError when ``routes_spec`` does not splice onto ``dfg`` —
    disk-cache callers treat that as a corrupt entry.
    """
    if routes_spec:
        routed, routes = splice_routes(dfg, [tuple(s) for s in routes_spec])
        return Mapping(dfg=routed, cgra=cgra, ii=ii, t_abs=t_abs,
                       placement=placement, routes=routes)
    return Mapping(dfg=dfg, cgra=cgra, ii=ii, t_abs=t_abs, placement=placement)


def _cache_put(base_key: tuple, mapping: Mapping) -> None:
    key = (*base_key, mapping.ii)
    _MAP_CACHE[key] = (
        list(mapping.t_abs), list(mapping.placement), mapping.routes_spec()
    )
    _MAP_CACHE.move_to_end(key)
    _MEM_CACHE_STATS.writes += 1
    while len(_MAP_CACHE) > _MAP_CACHE_MAX:
        _MAP_CACHE.popitem(last=False)
        _MEM_CACHE_STATS.evictions += 1


def _cache_get(
    base_key: tuple, lo_ii: int, hi_ii: int
) -> tuple[int, list[int], list[int], tuple] | None:
    for ii in range(lo_ii, hi_ii + 1):
        key = (*base_key, ii)
        hit = _MAP_CACHE.get(key)
        if hit is not None:
            _MAP_CACHE.move_to_end(key)
            _MEM_CACHE_STATS.hits += 1
            return ii, list(hit[0]), list(hit[1]), hit[2]
    _MEM_CACHE_STATS.misses += 1
    return None


def _cache_drop(base_key: tuple, ii: int) -> None:
    _MAP_CACHE.pop((*base_key, ii), None)


def cache_store_mapping(
    dfg: DFG,
    cgra: CGRA,
    mapping: Mapping,
    *,
    connectivity: str = "strict",
    max_register_pressure: int | None = None,
    max_route_hops: int = 0,
    space_backend: str = "auto",
    cache_dir: str | None = None,
) -> None:
    """Insert an externally produced valid mapping into both cache layers.

    The adoption path of the exact certification sweep (DESIGN.md §14.4): a
    ``better-found`` mapping comes from the joint backend, not from the
    portfolio, yet future compiles under the *same* option key must be able
    to serve it. The key mirrors ``_map_dfg_impl``'s lookup exactly —
    ``space_backend`` is resolved the same way, so ``"auto"`` callers hit
    what ``"auto"`` stores. The caller vouches for validity (``Compiler``
    only adopts mappings that passed ``Mapping.validate``); both layers
    re-validate on every read anyway.
    """
    resolved = resolve_space_backend_name(space_backend, cgra)
    base_key = _cache_base_key(
        dfg, cgra, connectivity, max_register_pressure, max_route_hops,
        resolved,
    )
    _cache_put(base_key, mapping)
    from .service.cache import DiskMappingCache, resolve_cache_dir

    root = resolve_cache_dir(cache_dir)
    if root is not None:
        DiskMappingCache(root).put(
            base_key, mapping.ii, mapping.t_abs, mapping.placement,
            routes=mapping.routes_spec(),
        )


def _pressure_offenders(mapping: Mapping, max_rp: int) -> list[int]:
    """PEs whose steady-state pressure exceeds their *effective* bound.

    The effective bound is per-PE — ``min(max_rp, cgra.registers_at(pe))`` —
    so a scalar budget sized for the largest register file (e.g. a 16-entry
    mem-PE file) can no longer wave through a mapping that oversubscribes a
    smaller per-class file on another PE.
    """
    # simulate imports this module for Mapping: import lazily
    from .simulate import register_pressure_by_pe

    cgra = mapping.cgra
    return [
        pe
        for pe, p in sorted(register_pressure_by_pe(mapping).items())
        if p > min(max_rp, cgra.registers_at(pe))
    ]


# ---------------------------------------------------------------- portfolio

@dataclass
class _Window:
    ii: int
    slack: int
    solver: TimeSolver | None = None
    infeasible: bool = False              # precheck ValueError: never opens
    yielded_any: bool = False             # produced >= 1 time solution ever
    pending: list[TimeSolution] = field(default_factory=list)  # space-failed


def ii_slack_windows(lo_ii: int, hi_ii: int, max_slack: int):
    """Canonical (II, slack) window order shared with the joint baseline."""
    for ii in range(lo_ii, hi_ii + 1):
        for slack in range(0, max_slack + 1):
            yield ii, slack


# Default slack depth of the sweep; shared with the racing clamp
# (service/batch.py) so both agree on the window-space size.
DEFAULT_MAX_SLACK = 3


def default_max_ii(m_ii: int) -> int:
    """Default upper II bound of the sweep.

    Single source of truth for the window-space size: used by ``map_dfg``
    and by the service layer's racing clamp (service/batch.py), which must
    agree on how many windows exist.
    """
    return max(m_ii * 4, m_ii + 8)


def map_dfg(dfg: DFG, cgra: CGRA, *, should_stop=None, **kwargs) -> MapResult:
    """Map ``dfg`` onto ``cgra`` — compatibility shim over ``repro_torch.api``.

    The stable entry point is now the :mod:`repro_torch.api` layer (DESIGN.md §11):
    every keyword this function historically accepted is a field of
    :class:`repro_torch.api.CompileOptions`, and this shim simply builds one and
    delegates — ``map_dfg(dfg, cgra, **kw)`` and
    ``Compiler(cgra, resolve_options(**kw)).compile(dfg)`` take the identical
    search path (the parity tests in ``tests/test_api.py`` pin this
    bit-for-bit). Unknown keywords raise ``TypeError`` via the options
    dataclass; statically-invalid combinations raise ``ValueError`` from
    ``CompileOptions.validate``.

    Example — map the paper's running example onto a 2×2 mesh::

        from repro_torch.core import CGRA, map_dfg, running_example

        res = map_dfg(running_example(), CGRA(2, 2))
        assert res.ok and res.mapping.ii == 4          # paper Fig. 2b
        print(res.mapping.pretty())                    # kernel table

    ``should_stop`` (a zero-arg cancellation callable) is not part of the
    serialisable options and stays a direct argument. See
    :func:`_map_dfg_impl` for the full option reference.
    """
    # lazy by design: the api layer imports this module, not vice versa
    from ..api.options import MAPPER_FIELDS, CompileOptions

    unknown = sorted(set(kwargs) - set(MAPPER_FIELDS))
    if unknown:
        # service-only CompileOptions fields (jobs, deadline_s, ...) must
        # fail here exactly like the historical signature's TypeError did —
        # silently ignoring a caller's budget/profile would be worse
        raise TypeError(
            f"map_dfg() got unexpected keyword arguments: {', '.join(unknown)}"
        )
    opts = CompileOptions(**kwargs)
    opts.validate()
    return _map_dfg_impl(
        dfg, cgra, should_stop=should_stop, **opts.mapper_kwargs()
    )


def _map_dfg_impl(
    dfg: DFG,
    cgra: CGRA,
    *,
    max_ii: int | None = None,
    max_slack: int = DEFAULT_MAX_SLACK,
    connectivity: str = "strict",
    backend: str = "auto",
    space_backend: str = "auto",
    time_budget_s: float = 120.0,
    space_timeout_s: float = 0.6,
    space_polish_timeout_s: float = 2.5,
    space_timeout_growth: float = 1.0,
    det_space_cap: int = 400_000,
    max_retries_per_window: int = 8,
    window_timeout_s: float = 10.0,
    max_register_pressure: int | None = None,
    max_route_hops: int = 0,
    deterministic: bool = False,
    use_cache: bool = True,
    cache_dir: str | None = None,
    window_offset: int = 0,
    window_stride: int = 1,
    should_stop=None,
    seed: int = 0,
) -> MapResult:
    """The portfolio-search engine behind ``map_dfg``/``Compiler.compile``.

    It sweeps (II, slack) *windows*
    starting at mII = max(ResII, RecII): for each window the time backend
    proposes a *label partition* (kernel step ``t mod II`` per node, plus a
    *fold* ``t div II``), and the monomorphism engine tries to embed it into
    the MRRG. The portfolio layer interleaves all windows in rounds of growing
    budgets (DESIGN.md §6), so an infeasible low II cannot starve the sweep.

    Example — map the paper's running example onto a 2×2 mesh::

        from repro_torch.core import CGRA, map_dfg, running_example

        res = map_dfg(running_example(), CGRA(2, 2))
        assert res.ok and res.mapping.ii == 4          # paper Fig. 2b
        print(res.mapping.pretty())                    # kernel table
        labels, folds = res.mapping.labels, res.mapping.folds

    Key options:

    * ``max_register_pressure`` enables register-file-aware mapping — the
      restriction the paper's §V-3 leaves to future work: mappings whose
      steady-state live-value count on any PE exceeds that PE's *effective*
      bound — ``min(max_register_pressure, cgra.registers_at(pe))`` — are
      rejected and the search continues, so accepted mappings are guaranteed
      to fit even per-class-sized register files (DESIGN.md §10.7). The
      offending PEs' schedules are re-realized (lifetime-compacted) before
      rejecting.
    * ``max_route_hops`` allows route-through mapping (DESIGN.md §12): when a
      label partition admits no direct embedding, the space engine may place
      G-adjacent ops up to ``1 + max_route_hops`` closed-adjacency steps
      apart and splice ``mov`` nodes (each occupying a real (PE, step) slot)
      onto the connecting path. Escalation is direct-first per partition:
      hops 0, then 1, ... then ``max_route_hops``, so direct embeddings are
      always preferred. 0 (the default) is the paper's direct-only behaviour,
      bit-identical to previous releases.
    * ``space_backend`` picks the placement engine (DESIGN.md §13):
      ``"exact"`` is the paper's complete bitset search, ``"anneal"`` the
      clustered simulated-annealing engine for very large fabrics, and
      ``"auto"`` (default) sizes the choice to the fabric — exact up to
      ``AUTO_EXACT_MAX_PES`` (400) PEs, anneal above, with an exact-engine
      rescue leg on deep portfolio rounds. ``space_timeout_s`` /
      ``space_polish_timeout_s`` / ``space_timeout_growth`` shape the
      per-call wall caps (polish dives get
      ``max(space_polish_timeout_s, space_timeout_s)``; fresh rounds grow as
      ``space_timeout_s * (1 + space_timeout_growth * round)``), and
      ``det_space_cap`` bounds per-round space nodes in deterministic mode.
    * ``deterministic=True`` swaps every wall-clock limit for node/step
      budgets so results are load-independent and reproducible;
      ``time_budget_s`` / ``space_timeout_s`` / ``window_timeout_s`` are then
      ignored, both mapping caches are bypassed (process/disk history must not
      leak into results), and the backend must be (or ``"auto"``-resolve to)
      the cp backend — z3 cannot honor step budgets.
    * ``cache_dir`` layers the persistent on-disk mapping cache (DESIGN.md §9)
      under the in-process LRU: memory first, disk second, solve last; a disk
      hit is promoted to memory and solved mappings are written to both.
      Defaults to ``$REPRO_CACHE_DIR`` when set; ``use_cache=False`` disables
      both layers.
    * ``window_offset`` / ``window_stride`` restrict the sweep to every
      ``stride``-th window of the canonical ``ii_slack_windows`` order — the
      striping used by the service layer to race one search across worker
      processes (DESIGN.md §8). ``should_stop`` (a zero-arg callable) is the
      matching cooperative-cancellation hook: polled at every budget check, a
      True return finishes with the best mapping found so far.
    """
    dfg.validate()
    if window_stride < 1 or not (0 <= window_offset < window_stride):
        raise ValueError(
            f"invalid window striping: offset {window_offset}, stride {window_stride}"
        )
    if max_route_hops < 0:
        raise ValueError(f"max_route_hops must be >= 0, got {max_route_hops}")
    if deterministic:
        # the bounded/reproducible contract only holds on the cp backend (z3
        # cannot honor step budgets), and only when process history cannot
        # leak in through the mapping cache
        if backend == "auto":
            backend = "cp"
        elif backend == "z3":
            raise ValueError(
                "deterministic=True requires the cp backend: z3 solves are "
                "wall-clock-bounded and load-dependent"
            )
        use_cache = False
    # resolve now so a bad backend name raises here instead of being
    # swallowed by the per-window infeasibility handler below
    backend = resolve_backend_name(backend)
    # "auto" is fabric-sized (exact <= AUTO_EXACT_MAX_PES PEs, anneal above,
    # DESIGN.md §13.3); remember the request so auto-on-large can still fall
    # back to the exact engine on deep rounds without surprising a caller
    # who *asked* for anneal
    space_auto = space_backend == "auto"
    space_backend = resolve_space_backend_name(space_backend, cgra)
    space_engine = create_space_backend(space_backend)
    exact_fallback = (
        create_space_backend("exact")
        if space_auto and space_backend != "exact" else None
    )
    stats = MapperStats()
    stats.space_backend = space_backend

    def timed_validate(mapping: Mapping) -> list[str]:
        t0 = _time.perf_counter()
        errs = mapping.validate(connectivity=connectivity, registers=False)
        stats.validate_s += _time.perf_counter() - t0
        return errs

    if cgra.heterogeneous:
        # fail fast on structurally impossible targets (an op class with no
        # capable PE) instead of exhausting the whole (II, slack) sweep
        unsupported = cgra.unsupported_ops(dfg)
        if unsupported:
            return MapResult(
                None, stats,
                reason="infeasible by capability: " + "; ".join(unsupported),
            )
    stats.res_ii = res_ii(dfg, cgra)
    stats.rec_ii = rec_ii(dfg)
    stats.m_ii = min_ii(dfg, cgra)
    start = _time.perf_counter()
    deadline = None if deterministic else start + time_budget_s
    hi = max_ii if max_ii is not None else default_max_ii(stats.m_ii)

    def pressure_reject(mapping: Mapping) -> bool:
        """Cache-served mappings must honor the same per-PE guarantee as
        freshly solved ones — a stale/poisoned entry that oversubscribes any
        PE's effective bound is rejected, never returned."""
        if max_register_pressure is None:
            return False
        return bool(_pressure_offenders(mapping, max_register_pressure))

    base_key = None
    disk = None
    if use_cache:
        base_key = _cache_base_key(
            dfg, cgra, connectivity, max_register_pressure, max_route_hops,
            space_backend,
        )
        stats.mem_cache_lookups += 1
        hit = _cache_get(base_key, stats.m_ii, hi)
        if hit is not None:
            ii, t_abs, placement, routes_spec = hit
            mapping = _rebuild_mapping(dfg, cgra, ii, t_abs, placement,
                                       routes_spec)
            if not timed_validate(mapping) and not pressure_reject(mapping):
                stats.cache_hit = True
                stats.mem_cache_hits += 1
                obs.event("cache.memory.hit", kernel=dfg.name, ii=ii)
                stats.final_ii = ii
                stats.backend = "cache"
                stats.total_s = _time.perf_counter() - start
                return MapResult(mapping, stats)
            _cache_drop(base_key, ii)   # invalid/oversubscribed: never serve
        if not stats.mem_cache_hits:
            obs.event("cache.memory.miss", kernel=dfg.name)
        # memory missed: consult the persistent layer (DESIGN.md §9).
        # Function-local import by design: service/batch.py imports this
        # module at top level, so a module-level import here would close an
        # import cycle — keep any future service imports lazy like this one.
        from .service.cache import DiskMappingCache, resolve_cache_dir

        resolved = resolve_cache_dir(cache_dir)
        if resolved is not None:
            disk = DiskMappingCache(resolved)
            lo = stats.m_ii
            stats.disk_cache_lookups += 1
            while True:
                dhit = disk.get(base_key, lo, hi)
                if dhit is None:
                    obs.event("cache.disk.miss", kernel=dfg.name)
                    break
                ii, t_abs, placement, routes_spec = dhit
                try:
                    mapping = _rebuild_mapping(dfg, cgra, ii, t_abs,
                                               placement, routes_spec)
                    invalid = bool(timed_validate(mapping)) or pressure_reject(
                        mapping
                    )
                except (ValueError, IndexError):
                    invalid = True      # routes don't splice onto this DFG
                if invalid:
                    # schema-valid but semantically invalid: drop it so it
                    # cannot poison every future cold lookup, try higher IIs
                    disk.invalidate(base_key, ii)
                    lo = ii + 1
                    continue
                _cache_put(base_key, mapping)          # promote to memory
                stats.disk_cache_hit = True
                stats.disk_cache_hits += 1
                stats.disk_cache_promotions += 1
                obs.event("cache.disk.hit", kernel=dfg.name, ii=ii)
                obs.event("cache.disk.promote", kernel=dfg.name, ii=ii)
                stats.final_ii = ii
                stats.backend = "disk-cache"
                stats.total_s = _time.perf_counter() - start
                return MapResult(mapping, stats)

    windows = [
        _Window(ii, s)
        for idx, (ii, s) in enumerate(ii_slack_windows(stats.m_ii, hi, max_slack))
        if idx % window_stride == window_offset
    ]
    # deterministic mode has no wall-clock backstop: the per-round node
    # budgets are capped so total work is bounded by rounds x windows x node
    # caps — det_space_cap is a CompileOptions field (one source of truth
    # shared with CI profiles); the cp-step cap stays local
    det_cp_cap = 400_000
    max_rounds = 6 if deterministic else 16
    # anytime polish: extra rounds on lower-II windows; wall-capped when not
    # deterministic, round-capped when it is
    improve_rounds = 3 if deterministic else 8
    solvers: list[TimeSolver] = []
    best: Mapping | None = None
    polish_left = 0
    produced_by = space_backend      # engine that placed the current best

    def out_of_time() -> bool:
        if should_stop is not None and should_stop():
            return True
        return deadline is not None and _time.perf_counter() > deadline

    def finish(mapping: Mapping | None, reason: str = "") -> MapResult:
        stats.time_phase_s += sum(s.stats.solver_time_s for s in solvers)
        stats.time_steps = sum(s.stats.steps for s in solvers)
        stats.total_s = _time.perf_counter() - start
        if mapping is not None:
            errs = timed_validate(mapping)
            if errs:  # defensive: should be impossible
                raise AssertionError(f"mapper produced invalid mapping: {errs}")
            stats.final_ii = mapping.ii
            stats.space_backend = produced_by
            if use_cache:
                _cache_put(base_key, mapping)
                if disk is not None:
                    disk.put(base_key, mapping.ii, mapping.t_abs,
                             mapping.placement, routes=mapping.routes_spec())
        return MapResult(mapping, stats, reason=reason)

    # how the last traced space probe's engine call ended (SpaceStats.outcome:
    # the engine's result, so a placement the register check rejects reads
    # found=False with outcome "found")
    probe_outcome = [""]

    def try_space(
        sol: TimeSolution, w: _Window, rnd: int,
        node_budget: int, restarts: int, salt: int = 0,
    ) -> Mapping | None:
        if not obs.enabled():
            return _try_space(sol, w, rnd, node_budget, restarts, salt)
        n0, r0 = stats.space_nodes_visited, stats.space_restarts
        with obs.span("space.probe", ii=w.ii, slack=w.slack, round=rnd,
                      engine=space_backend) as sp:
            mapping = _try_space(sol, w, rnd, node_budget, restarts, salt)
            sp.set(found=mapping is not None,
                   nodes=stats.space_nodes_visited - n0,
                   restarts=stats.space_restarts - r0,
                   outcome=probe_outcome[0])
            return mapping

    def _try_space(
        sol: TimeSolution, w: _Window, rnd: int,
        node_budget: int, restarts: int, salt: int = 0,
    ) -> Mapping | None:
        nonlocal produced_by
        sstats = SpaceStats()
        if deterministic:
            timeout = None
        elif best is not None:      # polish dive: deep per-call wall cap
            timeout = max(space_polish_timeout_s, space_timeout_s)
        else:
            timeout = space_timeout_s * (1 + space_timeout_growth * rnd)
        space = None
        # portfolio per (II, slack, fabric size): the resolved engine leads;
        # when "auto" resolved to anneal (very large fabric), deep rounds add
        # an exact-engine rescue leg — anneal is incomplete, and by round 2 a
        # partition that keeps failing has earned a complete search. Small
        # fabrics never take the extra leg, keeping the historical path
        # bit-identical.
        engines = [space_engine]
        if exact_fallback is not None and rnd >= 2:
            engines.append(exact_fallback)
        # escalation order (DESIGN.md §12.4): direct first, then one more
        # allowed hop per level — route-throughs are only spent when no
        # tighter embedding of this partition is found. hops == 0 takes the
        # exact historical call, keeping the direct path bit-identical; with
        # routing enabled the per-call wall cap is split across the levels so
        # a partition can never spend more than the historical cap in total.
        if timeout is not None and max_route_hops:
            timeout /= max_route_hops + 1
        for engine in engines:
            for hops in range(max_route_hops + 1):
                space = engine.place(
                    dfg, cgra, sol.labels, w.ii,
                    budget=SpaceBudget(
                        timeout_s=timeout,
                        node_budget=node_budget,
                        restarts=restarts,
                    ),
                    seed=seed * 8191 + rnd * 127 + w.slack * 17 + salt,
                    stats=sstats,
                    should_stop=should_stop,
                    **(
                        {} if hops == 0
                        else {"t_abs": sol.t_abs, "max_route_hops": hops}
                    ),
                )
                if space is not None:
                    break
            if space is not None:
                produced_by = engine.name
                break
        stats.space_phase_s += sstats.search_time_s
        stats.space_nodes_visited += sstats.nodes_visited
        stats.space_restarts += sstats.restarts
        if obs.enabled():
            probe_outcome[0] = sstats.outcome(
                space is not None, should_stop is not None and should_stop())
        if space is None:
            stats.mono_failures += 1
            return None
        if space.routes:
            # splice the materialised movs into the DFG (provenance-keeping
            # rewrite: original node ids unchanged, movs appended in route
            # order — exactly the order the extended arrays are built in)
            routed_dfg, routes = splice_routes(
                dfg,
                [(r.edge[0], r.edge[1], r.edge[2], len(r.path))
                 for r in space.routes],
            )
            mapping = Mapping(
                dfg=routed_dfg, cgra=cgra, ii=w.ii,
                t_abs=list(sol.t_abs) + [t for r in space.routes
                                         for t in r.times],
                placement=list(space.placement) + [pe for r in space.routes
                                                   for pe in r.path],
                routes=routes,
            )
        else:
            mapping = Mapping(
                dfg=dfg, cgra=cgra, ii=w.ii,
                t_abs=sol.t_abs, placement=space.placement,
            )
        if max_register_pressure is not None:
            offenders = _pressure_offenders(mapping, max_register_pressure)
            if offenders and not mapping.routes:
                # paper §V-3 extension: before rejecting, re-realize the
                # *offending PEs'* schedules with compacted lifetimes (same
                # labels => the found placement stays valid) — usually enough
                # to fit their files without disturbing the rest
                off_nodes = [
                    v for v in dfg.nodes if space.placement[v] in set(offenders)
                ]
                compact = w.solver.realize_compact(sol, nodes=off_nodes)
                mapping = Mapping(
                    dfg=dfg, cgra=cgra, ii=w.ii,
                    t_abs=compact.t_abs, placement=space.placement,
                )
                offenders = _pressure_offenders(mapping, max_register_pressure)
                if offenders:
                    # partial push wasn't enough: compact every lifetime
                    compact = w.solver.realize_compact(sol)
                    mapping = Mapping(
                        dfg=dfg, cgra=cgra, ii=w.ii,
                        t_abs=compact.t_abs, placement=space.placement,
                    )
                    offenders = _pressure_offenders(
                        mapping, max_register_pressure
                    )
            if offenders:
                # routed mappings skip re-realization (mov times are pinned
                # inside the original gaps); a different placement of the
                # same partition may still fit — pending, not blocked
                stats.mono_failures += 1
                return None
        return mapping

    polish_deadline: float | None = None

    def record(mapping: Mapping) -> None:
        """Anytime improvement: keep the best (lowest-II) mapping, restrict
        the remaining search to strictly lower IIs, grant polish rounds."""
        nonlocal best, polish_left, windows, deadline, polish_deadline
        if best is None or mapping.ii < best.ii:
            best = mapping
        polish_left = improve_rounds
        windows = [w for w in windows if w.ii < best.ii]
        if not deterministic and polish_deadline is None:
            # polish is bounded: a few multiples of the time-to-first-mapping,
            # never the whole remaining budget
            elapsed = _time.perf_counter() - start
            polish_s = max(5.0, min(20.0, 4 * elapsed, 0.25 * time_budget_s))
            polish_deadline = _time.perf_counter() + polish_s
            deadline = min(deadline, polish_deadline)

    rnd = 0
    while rnd < max_rounds:
        stats.rounds = rnd + 1
        obs.event("mapper.round", round=rnd, windows=len(windows),
                  best_ii=best.ii if best is not None else None)
        if best is not None:
            if polish_left <= 0 or not windows:
                return finish(best)
            polish_left -= 1
        # geometric budgets: cheap sweep first, deep dives on revisit; once an
        # incumbent exists, polish dives go straight to the deep end — the
        # polish deadline (or round cap) is the limiter, not the schedule
        space_cap = det_space_cap if deterministic else 4_000_000
        if best is None:
            space_nodes = min(15_000 * 8**rnd, space_cap)
            restarts = min(4 + 2 * rnd, 12)
        else:
            space_nodes = space_cap if not deterministic else min(15_000 * 8**rnd, space_cap)
            restarts = 10
        cp_steps = min(20_000 * 4**rnd, det_cp_cap if deterministic else 2_000_000)
        # fresh partitions get a cheap screen (embeddable ones usually embed
        # within a few k nodes); the deep budget goes to a rotating window of
        # pending partitions — many cheap probes beat few deep dives
        new_sols = min(4 + 4 * rnd, 4 * max(2, max_retries_per_window))
        screen_nodes = min(space_nodes, 25_000)
        screen_restarts = min(restarts, 4)
        deep_k = 4
        progress = False

        ii_seen_solution: set[int] = set()
        sweep = windows
        if best is not None:
            # polish: the II closest below the incumbent is the most likely
            # to embed — improve stepwise instead of sinking the polish
            # budget into (possibly space-infeasible) minimum-II windows
            sweep = sorted(windows, key=lambda x: (-x.ii, x.slack))
        for w in sweep:
            if w.infeasible:
                continue
            if out_of_time():
                return finish(best, "" if best else "time budget exhausted")
            # Deeper-slack windows mostly re-enumerate equivalent partitions —
            # only open slack s+1 once every shallower window of this II is
            # exhausted without ever yielding a time solution (matches the
            # old sweep's II-escalation behaviour). Under route-through the
            # extra slack is exactly where the mov firing slots come from
            # (each hop consumes one cycle of an edge's time gap), so there
            # the gate ignores yielded_any: deeper slack opens as soon as the
            # shallower windows are exhausted, even when their (unroutable)
            # partitions kept the old gate shut.
            if w.slack > 0:
                shallower = [
                    x for x in windows if x.ii == w.ii and x.slack < w.slack
                ]
                if any(
                    not x.infeasible
                    and ((max_route_hops == 0 and x.yielded_any)
                         or x.solver is None or not x.solver.exhausted)
                    for x in shallower
                ):
                    continue
            if w.solver is None:
                try:
                    w.solver = TimeSolver(
                        dfg, cgra, w.ii,
                        extra_slack=w.slack,
                        connectivity=connectivity,
                        backend=backend,
                        route_hops=max_route_hops,
                        timeout_s=None,
                        # seed 0 keeps the CP value order greedy (earliest-
                        # first), so each window's FIRST partition matches the
                        # classic modulo-scheduling packing; diversity comes
                        # from enumeration, not from scrambling the first shot
                        seed=seed * 31,
                    )
                except ValueError:
                    w.infeasible = True  # window can't hold the critical path
                    continue
                solvers.append(w.solver)
                stats.windows_opened += 1
                stats.backend = w.solver.stats.backend
                obs.event("mapper.window.open", ii=w.ii, slack=w.slack,
                          backend=stats.backend)
            # 1) retry cached partitions with this round's bigger space budget
            if rnd > 0 and w.pending:
                mapping = None
                for i in range(min(deep_k, len(w.pending))):
                    sol = w.pending.pop(0)
                    mapping = try_space(sol, w, rnd, space_nodes, restarts, salt=i)
                    if mapping is not None:
                        record(mapping)
                        break
                    w.pending.append(sol)   # back of the rotation queue
                    if out_of_time():
                        return finish(best, "" if best else "time budget exhausted")
                if not windows:   # record() trimmed everything below best away
                    return finish(best)
                if mapping is not None:
                    break  # windows trimmed: restart the sweep on lower IIs
                progress = True
            # 2) enumerate fresh partitions (bounded per round)
            if w.solver.exhausted or w.ii in ii_seen_solution:
                continue
            found = None
            for _ in range(new_sols):
                if out_of_time():
                    return finish(best, "" if best else "time budget exhausted")
                call_deadline = None
                if not deterministic:
                    call_deadline = min(
                        _time.perf_counter() + window_timeout_s, deadline
                    )
                sol = w.solver.next_solution(
                    deadline=call_deadline, step_budget=cp_steps
                )
                if sol is None:
                    break
                w.yielded_any = True
                ii_seen_solution.add(w.ii)
                stats.time_solutions_tried += 1
                progress = True
                found = try_space(sol, w, rnd, screen_nodes, screen_restarts)
                if found is not None:
                    record(found)
                    break
                w.pending.append(sol)
            if found is not None:
                if not windows:   # record() trimmed everything below best away
                    return finish(best)
                break  # windows trimmed: restart the sweep on lower IIs
        if not progress and all(
            w.infeasible or (w.solver is not None and w.solver.exhausted and not w.pending)
            for w in windows
        ):
            return finish(best, "" if best else f"search space exhausted up to II={hi}")
        rnd += 1
    return finish(best, "" if best else f"no mapping up to II={hi} within budget")
