"""Core library: monomorphism-based CGRA mapping via space/time decoupling.

The PyTorch port's own copy of the paper's mapper (the framework-free part
of the JAX package, carried over module for module): schedule.py
(ASAP/ALAP/MobS/KMS/mII), time_smt.py (time solution), space_backends/
(pluggable space solution: exact bitset monomorphism + annealing/clustered
placement, DESIGN.md §13), mapper.py (the decoupled pipeline), baseline.py
(joint SAT-MapIt-style comparison target), benchsuite.py (Table III DFG
suite), simulate.py (functional validation), arch/ (declarative
heterogeneous architecture specs: capability classes, topology families,
memory ports — DESIGN.md §10), service/ (persistent mapping cache, batch
compilation), exact_backends/ (exact joint solver, optimality
certificates), daemon/ (the persistent compile daemon and its unix-socket
transport), frontend.py (tracing a Python loop body into a DFG), fuzz.py
(seeded random DFGs for the differential harness) and placement.py (the
same algorithm placing model stage graphs onto device meshes).
Deterministic runs are bit-identical to the JAX package's.
"""

from .arch import ArchSpec, get_preset, list_presets, resolve_arch
from .cgra import CAP_CLASSES, CGRA, MRRG, op_class
from .dfg import DFG, Edge, Route, running_example, splice_routes
from .mapper import Mapping, MapResult, map_dfg
from .mono import check_monomorphism, check_routes, find_monomorphism
from .schedule import (
    KMS,
    MobilitySchedule,
    alap_schedule,
    asap_schedule,
    min_ii,
    mobility_schedule,
    rec_ii,
    res_ii,
)
from .space_backends import (
    SpaceBudget,
    available_space_backends,
    resolve_space_backend,
)
from .time_smt import (
    TimeSolution,
    TimeSolver,
    available_backends,
    check_time_solution,
)

__all__ = [
    "ArchSpec", "get_preset", "list_presets", "resolve_arch",
    "CAP_CLASSES", "op_class",
    "CGRA", "MRRG", "DFG", "Edge", "Route", "running_example", "splice_routes",
    "Mapping", "MapResult", "map_dfg",
    "check_monomorphism", "check_routes", "find_monomorphism",
    "SpaceBudget", "available_space_backends", "resolve_space_backend",
    "KMS", "MobilitySchedule", "alap_schedule", "asap_schedule",
    "min_ii", "mobility_schedule", "rec_ii", "res_ii",
    "TimeSolution", "TimeSolver", "check_time_solution", "available_backends",
]
