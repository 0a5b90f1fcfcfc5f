"""Compatibility shim: the monomorphism engine lives in ``space_backends``.

The bitset search (paper §IV-C) moved, unchanged, to
``core/space_backends/exact.py`` when the space phase became pluggable
(DESIGN.md §13); the shared datatypes and route-repair machinery sit in
``core/space_backends/base.py``. This module keeps the historical import
surface — ``from repro_torch.core.mono import find_monomorphism`` and friends —
working for existing callers and tests.
"""

from .space_backends.base import (  # noqa: F401
    MaterializedRoute,
    SpaceSolution,
    SpaceStats,
    _RouteContext,
    check_monomorphism,
    check_routes,
)
from .space_backends.exact import (  # noqa: F401
    _search_once,
    find_monomorphism,
)

__all__ = [
    "MaterializedRoute",
    "SpaceSolution",
    "SpaceStats",
    "check_monomorphism",
    "check_routes",
    "find_monomorphism",
]
