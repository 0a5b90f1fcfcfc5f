"""Pluggable space backends (DESIGN.md §13).

Importing this package registers the exact engine; resolve by name (or pass
an instance straight through)::

    from repro_torch.core.space_backends import resolve_space_backend
    backend = resolve_space_backend("auto", cgra)   # exact up to 400 PEs
    sol = backend.place(dfg, cgra, labels, ii, budget=SpaceBudget(timeout_s=2.0))
"""

from .base import (
    AUTO_EXACT_MAX_PES,
    MaterializedRoute,
    SpaceBackend,
    SpaceBackendNotPorted,
    SpaceBudget,
    SpaceSolution,
    SpaceStats,
    available_space_backends,
    check_monomorphism,
    check_routes,
    create_space_backend,
    register_space_backend,
    resolve_space_backend,
    resolve_space_backend_name,
)
from .exact import ExactSpaceBackend, find_monomorphism

__all__ = [
    "AUTO_EXACT_MAX_PES",
    "ExactSpaceBackend",
    "MaterializedRoute",
    "SpaceBackend",
    "SpaceBackendNotPorted",
    "SpaceBudget",
    "SpaceSolution",
    "SpaceStats",
    "available_space_backends",
    "check_monomorphism",
    "check_routes",
    "create_space_backend",
    "find_monomorphism",
    "register_space_backend",
    "resolve_space_backend",
    "resolve_space_backend_name",
]
