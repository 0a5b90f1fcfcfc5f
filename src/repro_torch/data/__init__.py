from .pipeline import MemmapLM, SyntheticLM

__all__ = ["MemmapLM", "SyntheticLM"]
