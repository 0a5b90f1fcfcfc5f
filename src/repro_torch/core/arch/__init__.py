"""Architecture-description subsystem (DESIGN.md §10).

Declarative, serialisable CGRA specs — capability classes per PE, topology
family, memory ports, register-file size — plus a library of named presets.
``ArchSpec.cgra()`` compiles a spec into the runtime ``CGRA`` model; the
capability information then flows through the time backends (per-op-class
capacity), the space engine (candidate-mask intersection), the simulator
(hard capability/port assertions) and the mapping caches (spec hash in the
key).
"""

from .presets import PRESETS, get_preset, list_presets
from .spec import ArchSpec, op_class, resolve_arch

__all__ = [
    "ArchSpec",
    "PRESETS",
    "get_preset",
    "list_presets",
    "op_class",
    "resolve_arch",
]
