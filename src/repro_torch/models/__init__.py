"""The LM model zoo in PyTorch: configs' data types (api), layers,
attention, the decoder-LM assembly (build) and ``build_model`` (zoo).
Only the dense family is ported."""

from .zoo import build_model, param_count

__all__ = ["build_model", "param_count"]
