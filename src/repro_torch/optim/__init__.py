"""Optimizers and distributed-optimization utilities."""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm, lr_at
from .compression import (
    compress, compress_grads_with_feedback, decompress, init_residual,
)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "global_norm", "lr_at",
    "compress", "compress_grads_with_feedback", "decompress", "init_residual",
]
