"""The benchmark measures the port alone: no JAX, no JAX package.

Module names are compared by their top-level name (the part before the
first dot) whole, so ``repro_torch`` passes and ``repro`` does not.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is forbidden, sorted (an entry
    of None in ``sys.modules`` blocks an import and is not a module)."""
    names = ([k for k, v in sys.modules.items() if v is not None]
             if modules is None else modules)
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
