"""Pluggable space backends (DESIGN.md §13).

Importing this package registers both engines; resolve by name (or pass an
instance straight through)::

    from repro_torch.core.space_backends import resolve_space_backend
    backend = resolve_space_backend("auto", cgra)   # exact <=400 PEs, else anneal
    sol = backend.place(dfg, cgra, labels, ii, budget=SpaceBudget(timeout_s=2.0))
"""

from .base import (
    AUTO_EXACT_MAX_PES,
    MaterializedRoute,
    SpaceBackend,
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
from .anneal import AnnealSpaceBackend
from .exact import ExactSpaceBackend, find_monomorphism

__all__ = [
    "AUTO_EXACT_MAX_PES",
    "AnnealSpaceBackend",
    "ExactSpaceBackend",
    "MaterializedRoute",
    "SpaceBackend",
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
