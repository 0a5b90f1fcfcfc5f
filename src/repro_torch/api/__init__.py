"""Stable public compiler API (DESIGN.md §11).

The one import users and frontends should reach for::

    from repro_torch.api import Compiler, CompileOptions, resolve_options

    comp = Compiler("satmapit_edge_mem_4x4", resolve_options("fast"))
    res = comp.compile(dfg)            # -> CompileResult (unified schema)
    batch = comp.compile_batch(dfgs)   # -> BatchResult (process pool)

Three pieces:

* :class:`~repro_torch.api.options.CompileOptions` — frozen, JSON-round-trippable
  configuration with named profiles (``fast`` / ``quality`` /
  ``deterministic-ci``) and the single CLI flag definition
  (:func:`~repro_torch.api.options.add_cli_args` /
  :func:`~repro_torch.api.options.resolve_options`).
* :class:`~repro_torch.api.compiler.Compiler` — a session binding
  ``(target, options, caches)`` with ``compile`` / ``compile_batch`` /
  ``compile_racing`` routed to the mapper and service internals.
* :class:`~repro_torch.api.result.CompileResult` — the unified structured outcome
  (phase timings, search trace, cache provenance, machine-readable failure
  codes) serialised identically by every frontend.

``repro_torch.core.map_dfg(**kwargs)`` remains as a thin compatibility shim that
builds a ``CompileOptions`` and delegates — old call sites keep working and
stay bit-identical (see ``tests/test_api.py`` parity tests).
"""

from .compiler import Compiler
from .options import (
    MAPPER_FIELDS,
    PROFILES,
    SERVICE_FIELDS,
    CompileOptions,
    add_cli_args,
    options_from_args,
    resolve_options,
)
from .result import (
    FAILURE_KINDS,
    BatchResult,
    CompileResult,
    PhaseTimings,
    SearchTrace,
    classify_failure,
)

__all__ = [
    "Compiler",
    "CompileOptions",
    "CompileResult",
    "BatchResult",
    "PhaseTimings",
    "SearchTrace",
    "PROFILES",
    "MAPPER_FIELDS",
    "SERVICE_FIELDS",
    "FAILURE_KINDS",
    "add_cli_args",
    "options_from_args",
    "resolve_options",
    "classify_failure",
]
