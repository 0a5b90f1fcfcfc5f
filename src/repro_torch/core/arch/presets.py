"""Named architecture presets (DESIGN.md §10).

Each preset is a factory returning a fresh :class:`~repro_torch.core.arch.ArchSpec`
mirroring a machine from the paper or its companion line of work:

* ``paper_homogeneous_4x4`` — the paper's §V evaluation grid: 4×4 mesh,
  every PE executes every op.
* ``satmapit_edge_mem_4x4`` — SAT-MapIt-style (arXiv 2512.02875): only the
  twelve border PEs of a 4×4 mesh reach memory (4 load/store ports), interior
  PEs are pure compute; every PE keeps the full ALU + multiplier. Memory PEs
  carry a double-size register file (``registers_by_class``) — the
  buffer-sizing asymmetry such machines use for load/store latency hiding.
* ``mul_sparse_8x8`` — an 8×8 mesh where only the main-diagonal PEs carry a
  multiplier/divider (the classic area-saving layout); memory everywhere.
* ``diagonal_20x20`` — a large king-move (diagonal) grid, homogeneous
  capabilities: exercises the non-bipartite-topology path at scale.
* ``onehop_split_4x4`` — a one-hop grid whose memory and multiplier banks
  sit on opposite columns, 3 apart: the route-through demo machine
  (``--max-route-hops``, DESIGN.md §12).
* ``mesh_50x50`` / ``mesh_100x100`` — large homogeneous meshes (2.5k and
  10k PEs): the scale regime the annealing space backend opens up
  (DESIGN.md §13; auto-selection sends them to ``anneal``).

``list_presets()``/``get_preset()`` are the registry surface the CLIs use.
"""

from __future__ import annotations

from typing import Callable

from .spec import ArchSpec

__all__ = ["PRESETS", "get_preset", "list_presets"]


def _border_mem(rows: int, cols: int, classes_border: tuple[str, ...],
                classes_interior: tuple[str, ...]) -> tuple[tuple[str, ...], ...]:
    out = []
    for r in range(rows):
        for c in range(cols):
            edge = r in (0, rows - 1) or c in (0, cols - 1)
            out.append(classes_border if edge else classes_interior)
    return tuple(out)


def paper_homogeneous_4x4() -> ArchSpec:
    return ArchSpec(name="paper_homogeneous_4x4", rows=4, cols=4)


def satmapit_edge_mem_4x4() -> ArchSpec:
    return ArchSpec(
        name="satmapit_edge_mem_4x4",
        rows=4,
        cols=4,
        pe_classes=_border_mem(4, 4, ("alu", "mem", "mul"), ("alu", "mul")),
        mem_ports=4,
        registers_by_class={"mem": 16},
    )


def mul_sparse_8x8() -> ArchSpec:
    classes = tuple(
        ("alu", "mem", "mul") if r == c else ("alu", "mem")
        for r in range(8)
        for c in range(8)
    )
    return ArchSpec(name="mul_sparse_8x8", rows=8, cols=8, pe_classes=classes)


def diagonal_20x20() -> ArchSpec:
    return ArchSpec(name="diagonal_20x20", rows=20, cols=20, topology="diagonal")


def onehop_split_4x4() -> ArchSpec:
    """One-hop 4×4 with memory and multiplier banks on opposite columns.

    Column 0 PEs are the only memory ports, column 3 PEs the only
    multipliers, the middle columns plain ALUs. Even with the one-hop
    links (distance-2 row/column hops) the two banks sit 3 apart, so *any*
    load→mul or mul→store dependency is unmappable under direct adjacency —
    the machine shape that needs route-through mapping
    (``--max-route-hops``): one mov on a middle-column PE bridges the banks.
    """
    classes = tuple(
        ("alu", "mem") if c == 0 else ("alu", "mul") if c == 3 else ("alu",)
        for _r in range(4)
        for c in range(4)
    )
    return ArchSpec(
        name="onehop_split_4x4", rows=4, cols=4, topology="one-hop",
        pe_classes=classes,
    )


def mesh_50x50() -> ArchSpec:
    return ArchSpec(name="mesh_50x50", rows=50, cols=50)


def mesh_100x100() -> ArchSpec:
    return ArchSpec(name="mesh_100x100", rows=100, cols=100)


PRESETS: dict[str, Callable[[], ArchSpec]] = {
    "paper_homogeneous_4x4": paper_homogeneous_4x4,
    "satmapit_edge_mem_4x4": satmapit_edge_mem_4x4,
    "mul_sparse_8x8": mul_sparse_8x8,
    "diagonal_20x20": diagonal_20x20,
    "onehop_split_4x4": onehop_split_4x4,
    "mesh_50x50": mesh_50x50,
    "mesh_100x100": mesh_100x100,
}


def get_preset(name: str) -> ArchSpec:
    """Build a preset by name; the spec is validated before it is returned."""
    try:
        factory = PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r} (choose from {', '.join(sorted(PRESETS))})"
        ) from None
    spec = factory()
    spec.validate()
    return spec


def list_presets() -> list[str]:
    return sorted(PRESETS)
