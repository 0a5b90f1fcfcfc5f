"""Time-solver backend subsystem (DESIGN.md §4).

The time phase is a pluggable constraint solver behind a small protocol
(`base.TimeBackend`): the faithful Z3 SMT encoding when `z3-solver` is
installed, and a dependency-free incremental CP solver otherwise. Backends are
looked up through the registry so `TimeSolver` (core/time_smt.py) can report
exactly which engine produced a schedule.
"""

from .base import (
    BackendUnavailable,
    TimeProblem,
    available_backends,
    create_backend,
    resolve_backend_name,
)
from .cp_backend import IncrementalCPBackend
from .z3_backend import HAVE_Z3, Z3Backend

__all__ = [
    "BackendUnavailable",
    "TimeProblem",
    "available_backends",
    "create_backend",
    "resolve_backend_name",
    "IncrementalCPBackend",
    "Z3Backend",
    "HAVE_Z3",
]
