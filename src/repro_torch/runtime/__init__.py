from .fault import FaultConfig, RunReport, run_training

__all__ = ["FaultConfig", "RunReport", "run_training"]
