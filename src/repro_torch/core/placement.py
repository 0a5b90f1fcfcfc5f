"""Beyond-paper application: space/time-decoupled placement on TPU meshes.

A TPU slice is a 2-D/3-D torus of chips connected by near-neighbour ICI links
— structurally the same substrate as a CGRA mesh of PEs. The paper's insight
(schedule in time under capacity/connectivity constraints, then place with a
monomorphism so every dependency is a single hop) therefore transfers directly
to the placement problems a distributed LM framework faces:

  * pipeline-parallel stage placement: stages = DFG nodes, activations flowing
    stage->stage = edges, II = the pipeline's steady-state repeat interval.
    A monomorphic placement means all stage boundaries are single-hop ICI
    transfers, lowerable to `collective_permute` (cheap, contention-free)
    instead of arbitrary point-to-point routes.
  * MoE expert-group placement: expert groups = nodes, heavy token routes
    (profiled or uniform) = edges; neighbour placement keeps the all-to-all's
    heaviest pairs on single hops.

The device "CGRA" uses torus topology (ICI wraps around); everything else —
the SMT time solver, the monomorphism search — is reused unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

from .cgra import CGRA
from .dfg import DFG, Edge
from .mapper import MapResult, Mapping, map_dfg


@dataclass(frozen=True)
class StageGraph:
    """A model partitioned into communicating stages (pipeline or experts)."""

    num_stages: int
    # (src, dst, carried): carried=True marks the steady-state wrap edge
    # (microbatch i+1 enters stage 0 while microbatch i is downstream).
    flows: tuple[tuple[int, int, bool], ...]
    name: str = "stages"

    def to_dfg(self) -> DFG:
        # carried (wrap) edges span the whole pipeline: distance = depth
        edges = [
            Edge(s, d, self.num_stages if carried else 0)
            for s, d, carried in self.flows
        ]
        ops = []
        for v in range(self.num_stages):
            indeg = sum(1 for _, d, _ in self.flows if d == v)
            ops.append({0: "input", 1: "mov", 2: "phi"}.get(indeg, "add"))
        return DFG(num_nodes=self.num_stages, edges=edges, ops=ops, name=self.name)


def linear_pipeline(num_stages: int, *, wrap: bool = True, name: str = "pipeline") -> StageGraph:
    """Classic 1F1B-style pipeline: stage i feeds stage i+1; the wrap edge
    models microbatch m+num_stages re-entering stage 0 while m drains — its
    dependence distance equals the pipeline depth, so RecII stays 1 and the
    mapper seeks a *fully spatial* solution (II=1: all stages concurrently on
    distinct, adjacent devices — the steady-state pipeline)."""
    flows = [(i, i + 1, False) for i in range(num_stages - 1)]
    if wrap and num_stages > 1:
        flows.append((num_stages - 1, 0, True))
    return StageGraph(num_stages, tuple(flows), name=name)


def mesh_as_cgra(shape: tuple[int, int], *, registers_per_pe: int = 32) -> CGRA:
    """Model a TPU chip/host grid as a torus 'CGRA' (ICI links wrap)."""
    return CGRA(rows=shape[0], cols=shape[1], topology="torus",
                registers_per_pe=registers_per_pe)


@dataclass
class DevicePlacement:
    """stage -> device coordinate on the mesh, plus the schedule phase."""

    mesh_shape: tuple[int, int]
    stage_to_device: list[tuple[int, int]]
    stage_phase: list[int]
    ii: int
    mapping: Mapping

    def single_hop_fraction(self) -> float:
        """Fraction of stage flows that are single-hop (or same-device)."""
        cgra = self.mapping.cgra
        ok = 0
        edges = self.mapping.dfg.edges
        for e in edges:
            pu = self.mapping.placement[e.src]
            pv = self.mapping.placement[e.dst]
            if cgra.adjacency[pu][pv]:
                ok += 1
        return ok / max(1, len(edges))

    def permute_pairs(self) -> list[tuple[int, int]]:
        """(src_device, dst_device) pairs for a collective_permute lowering."""
        out = []
        for e in self.mapping.dfg.edges:
            pu = self.mapping.placement[e.src]
            pv = self.mapping.placement[e.dst]
            if pu != pv:
                out.append((pu, pv))
        return sorted(set(out))


def place_stages(
    stages: StageGraph,
    mesh_shape: tuple[int, int],
    *,
    time_budget_s: float = 30.0,
) -> DevicePlacement | None:
    """Place a stage graph onto a device mesh with the paper's mapper."""
    cgra = mesh_as_cgra(mesh_shape)
    dfg = stages.to_dfg()
    res: MapResult = map_dfg(dfg, cgra, time_budget_s=time_budget_s)
    if not res.ok:
        return None
    m = res.mapping
    return DevicePlacement(
        mesh_shape=mesh_shape,
        stage_to_device=[cgra.pe_coords(p) for p in m.placement],
        stage_phase=list(m.labels),
        ii=m.ii,
        mapping=m,
    )


def expert_groups_graph(
    num_groups: int,
    heavy_routes: Sequence[tuple[int, int]] = (),
    name: str = "experts",
) -> StageGraph:
    """MoE expert-group placement problem: groups exchanging the heaviest
    token traffic (profiled or assumed) become edges; a monomorphic placement
    puts each hot pair on a single ICI hop, so the all-to-all's dominant
    flows avoid multi-hop congestion. Groups with no profiled affinity get a
    ring backbone (every group still adjacent to a neighbour for the
    fallback uniform traffic)."""
    flows = [(i, (i + 1) % num_groups, (i + 1) == num_groups)
             for i in range(num_groups)]
    # canonicalise heavy routes low->high so the intra-iteration graph stays
    # acyclic (placement only needs adjacency, which is undirected anyway)
    flows += [(min(a, b), max(a, b), False) for a, b in heavy_routes]
    # dedupe
    seen, uniq = set(), []
    for s, d, c in flows:
        if (s, d) not in seen and s != d:
            seen.add((s, d))
            uniq.append((s, d, c))
    return StageGraph(num_groups, tuple(uniq), name=name)


def device_order_for_pipeline(num_stages: int, mesh_shape: tuple[int, int]) -> list[int]:
    """Flat device ordering for `jax.make_mesh`-style pipeline axes such that
    consecutive pipeline stages sit on ICI-adjacent devices.

    Falls back to a snake order (always single-hop on a torus row-major grid)
    if the mapper declines, so callers can rely on a result.
    """
    placement = place_stages(linear_pipeline(num_stages), mesh_shape)
    if placement is not None and placement.single_hop_fraction() == 1.0:
        cgra = mesh_as_cgra(mesh_shape)
        return [cgra.pe_index(r, c) for r, c in placement.stage_to_device]
    # snake fallback
    rows, cols = mesh_shape
    order: list[int] = []
    for r in range(rows):
        cs = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        order.extend(r * cols + c for c in cs)
    return order[:num_stages]
