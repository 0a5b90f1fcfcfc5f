"""Core library: monomorphism-based CGRA mapping via space/time decoupling.

The PyTorch port's own copy of the paper's mapper (the framework-free part
of the JAX package, carried over module for module): schedule.py
(ASAP/ALAP/MobS/KMS/mII), time_smt.py (time solution on the CP backend),
space_backends/ (the exact bitset monomorphism engine), mapper.py (the
decoupled pipeline), benchsuite.py (Table III DFG suite) and simulate.py
(functional validation). Deterministic runs are bit-identical to the JAX
package's.
"""

from .cgra import CAP_CLASSES, CGRA, MRRG, op_class
from .dfg import DFG, Edge, Route, running_example, splice_routes
from .mapper import Mapping, MapResult, map_dfg
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
    check_monomorphism,
    check_routes,
    find_monomorphism,
    resolve_space_backend,
)
from .time_smt import (
    TimeSolution,
    TimeSolver,
    available_backends,
    check_time_solution,
)

__all__ = [
    "CAP_CLASSES", "op_class",
    "CGRA", "MRRG", "DFG", "Edge", "Route", "running_example", "splice_routes",
    "Mapping", "MapResult", "map_dfg",
    "check_monomorphism", "check_routes", "find_monomorphism",
    "SpaceBudget", "available_space_backends", "resolve_space_backend",
    "KMS", "MobilitySchedule", "alap_schedule", "asap_schedule",
    "min_ii", "mobility_schedule", "rec_ii", "res_ii",
    "TimeSolution", "TimeSolver", "check_time_solution", "available_backends",
]
