"""Time-solver backend subsystem (DESIGN.md §4).

The time phase is a pluggable constraint solver behind a small protocol
(`base.TimeBackend`). This package registers the dependency-free incremental
CP solver; the Z3 SMT encoding of the JAX package is not ported yet, and
asking for it raises `BackendUnavailable`. Backends are looked up through the
registry so `TimeSolver` (core/time_smt.py) can report exactly which engine
produced a schedule.
"""

from .base import (
    BackendUnavailable,
    TimeProblem,
    available_backends,
    create_backend,
    resolve_backend_name,
)
from .cp_backend import IncrementalCPBackend

__all__ = [
    "BackendUnavailable",
    "TimeProblem",
    "available_backends",
    "create_backend",
    "resolve_backend_name",
    "IncrementalCPBackend",
]
