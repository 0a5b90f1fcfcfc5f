"""Optimizers and distributed-optimization utilities."""

from .adamw import (
    AdamWConfig, adamw_init, adamw_update, adamw_update_sharded, build_opt_shardings,
    global_norm, lr_at, moment_shardings,
)
from .compression import (
    compress, compress_grads_with_feedback, compressed_psum_mean, decompress,
    init_residual,
)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "adamw_update_sharded",
    "build_opt_shardings", "global_norm", "lr_at", "moment_shardings",
    "compress", "compress_grads_with_feedback", "compressed_psum_mean", "decompress",
    "init_residual",
]
