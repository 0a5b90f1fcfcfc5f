"""Compilation service: batch mapping across processes + persistent cache.

The throughput layer over the single-shot mapper (DESIGN.md §8–§9):

* :func:`compile_many` — process-pool batch compiler (per-job deadlines,
  cooperative cancellation, deterministic mode for CI).
* :func:`map_dfg_racing` — intra-job parallelism: one mapping problem's
  (II, slack) windows raced across workers with first-winner cancellation.
* :class:`DiskMappingCache` — content-addressed on-disk mapping store the
  in-memory LRU layers over; ``$REPRO_CACHE_DIR`` enables it globally.

CLI front-end: ``python -m repro_torch.compile`` (see ``repro_torch/compile.py``).
"""

from .batch import (
    CompileJob,
    CompileReport,
    JobReport,
    compile_many,
    map_dfg_racing,
)
from .cache import CACHE_VERSION, CacheStats, DiskMappingCache, resolve_cache_dir

__all__ = [
    "CompileJob",
    "CompileReport",
    "JobReport",
    "compile_many",
    "map_dfg_racing",
    "CACHE_VERSION",
    "CacheStats",
    "DiskMappingCache",
    "resolve_cache_dir",
]
