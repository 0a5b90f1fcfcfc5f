from .elastic import best_mesh_shape, remesh, reshard_state
from .fault import FaultConfig, RunReport, run_training

__all__ = [
    "FaultConfig", "RunReport", "run_training",
    "best_mesh_shape", "remesh", "reshard_state",
]
