"""Declarative CGRA architecture descriptions (DESIGN.md §10).

An :class:`ArchSpec` is the serialisable source of truth for a target
machine: grid dimensions, topology family, per-PE capability classes,
memory-port count and register-file size. It compiles to the runtime
:class:`~repro_torch.core.cgra.CGRA` model via :meth:`ArchSpec.cgra`, validates
against a workload via :meth:`ArchSpec.validate_for`, and hashes stably via
:meth:`ArchSpec.spec_hash` (the digest the mapping caches fold into their
keys, alongside ``CGRA.arch_token``).

The JSON format is deliberately small::

    {
      "name": "satmapit_edge_mem_4x4",
      "rows": 4, "cols": 4,
      "topology": "mesh",
      "pe_classes": [["alu", "mem"], ["alu"], ...],   // row-major, or null
      "mem_ports": 4,                                  // or null
      "registers_per_pe": 8,
      "registers_by_class": {"mem": 16}                // or null (scalar only)
    }

``pe_classes: null`` means homogeneous (every PE, every class). Named
presets live in :mod:`repro_torch.core.arch.presets`; :func:`resolve_arch` turns a
CLI argument (preset name or ``.json`` path) into a spec.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, replace
from functools import cached_property

from ..cgra import CGRA, op_class

__all__ = ["ArchSpec", "op_class", "resolve_arch"]


@dataclass(frozen=True)
class ArchSpec:
    """Declarative description of a (possibly heterogeneous) CGRA target.

    Example — a 2×2 grid where only the left column touches memory::

        spec = ArchSpec(
            name="tiny", rows=2, cols=2,
            pe_classes=(("alu", "mem", "mul"), ("alu",),
                        ("alu", "mem", "mul"), ("alu",)),
            mem_ports=1,
        )
        spec.validate()
        cgra = spec.cgra()
        assert cgra.capable(0, "mem") and not cgra.capable(1, "mem")
        again = ArchSpec.from_json(spec.to_json())
        assert again.spec_hash() == spec.spec_hash()
    """

    name: str
    rows: int
    cols: int
    topology: str = "mesh"
    # per-PE capability classes, row-major; None = every PE every class
    pe_classes: tuple[tuple[str, ...], ...] | None = None
    # max memory ops per cycle grid-wide; None = one port per mem-capable PE
    mem_ports: int | None = None
    registers_per_pe: int = 8
    # per-capability-class register-file override (e.g. {"mem": 16} sizes
    # memory-PE buffers differently, SAT-MapIt-style); a dict or a
    # ((class, count), ...) tuple, normalised to the sorted tuple form.
    # None = every PE gets the scalar registers_per_pe
    registers_by_class: tuple[tuple[str, int], ...] | None = None

    def __post_init__(self) -> None:
        if isinstance(self.registers_by_class, dict):
            object.__setattr__(
                self, "registers_by_class",
                tuple(sorted(self.registers_by_class.items())),
            )
        elif self.registers_by_class is not None:
            object.__setattr__(
                self, "registers_by_class",
                tuple(sorted(tuple(p) for p in self.registers_by_class)),
            )

    # ------------------------------------------------------------- validation
    def validate(self) -> None:
        """Raise ValueError on a structurally invalid spec.

        The grid/topology/class/port invariants are owned by
        ``CGRA.__post_init__`` — constructing the CGRA *is* the check, so the
        two layers cannot drift; this only adds the spec-level extras and a
        name-prefixed message for file-loaded specs.
        """
        if self.registers_per_pe < 1:
            raise ValueError(f"{self.name}: registers_per_pe must be >= 1")
        try:
            self._cgra  # noqa: B018 — cached construction runs the checks
        except ValueError as exc:
            raise ValueError(f"{self.name}: {exc}") from None

    def validate_for(self, dfg) -> list[str]:
        """Workload-level feasibility: every DFG op class needs ≥1 capable PE
        (and a non-zero port budget for memory ops). Returns problems, not
        raises, so batch frontends can report per-job."""
        return self.cgra().unsupported_ops(dfg)

    # ------------------------------------------------------------ compilation
    @cached_property
    def _cgra(self) -> CGRA:
        return CGRA(
            rows=self.rows,
            cols=self.cols,
            topology=self.topology,
            registers_per_pe=self.registers_per_pe,
            pe_classes=self.pe_classes,
            mem_ports=self.mem_ports,
            registers_by_class=self.registers_by_class,
        )

    def cgra(self) -> CGRA:
        """The runtime machine model this spec describes."""
        self.validate()
        return self._cgra

    def spec_hash(self) -> str:
        """Stable content digest over everything mapping-relevant.

        ``name`` is excluded — renaming a preset must not orphan cached
        mappings. The same digest feeds cache keys and BENCH artifacts.
        """
        payload = json.dumps(
            {
                "rows": self.rows,
                "cols": self.cols,
                "topology": self.topology,
                "pe_classes": (
                    None if self.pe_classes is None
                    else [sorted(c) for c in self.pe_classes]
                ),
                "mem_ports": self.mem_ports,
                "registers_per_pe": self.registers_per_pe,
                "registers_by_class": (
                    None if self.registers_by_class is None
                    else dict(self.registers_by_class)
                ),
            },
            sort_keys=True,
            separators=(",", ":"),
        )
        return hashlib.sha1(payload.encode()).hexdigest()

    # ------------------------------------------------------------------- I/O
    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "rows": self.rows,
                "cols": self.cols,
                "topology": self.topology,
                "pe_classes": (
                    None if self.pe_classes is None
                    else [list(c) for c in self.pe_classes]
                ),
                "mem_ports": self.mem_ports,
                "registers_per_pe": self.registers_per_pe,
                "registers_by_class": (
                    None if self.registers_by_class is None
                    else dict(self.registers_by_class)
                ),
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "ArchSpec":
        # every malformation surfaces as ValueError so CLI frontends can
        # catch one exception type and print a clean message
        try:
            d = json.loads(text)
            pe_classes = d.get("pe_classes")
            spec = cls(
                name=d.get("name", "arch"),
                rows=d["rows"],
                cols=d["cols"],
                topology=d.get("topology", "mesh"),
                pe_classes=(
                    None if pe_classes is None
                    else tuple(tuple(c) for c in pe_classes)
                ),
                mem_ports=d.get("mem_ports"),
                registers_per_pe=d.get("registers_per_pe", 8),
                registers_by_class=d.get("registers_by_class"),
            )
        except (KeyError, TypeError, AttributeError) as exc:
            raise ValueError(f"malformed ArchSpec JSON: {exc!r}") from None
        spec.validate()
        return spec

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "ArchSpec":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_json(f.read())

    def renamed(self, name: str) -> "ArchSpec":
        return replace(self, name=name)


def resolve_arch(arg: str) -> ArchSpec:
    """Resolve a CLI ``--arch`` argument: preset name first, file path second.

    Raises ValueError with the preset list when neither matches, so the CLI
    error is self-documenting.
    """
    from .presets import PRESETS, get_preset

    if arg in PRESETS:
        return get_preset(arg)
    import os

    if os.path.exists(arg):
        return ArchSpec.load(arg)
    raise ValueError(
        f"unknown architecture {arg!r}: not a preset "
        f"({', '.join(sorted(PRESETS))}) and not a file"
    )
