"""qwen3-0.6b [dense] — hf:Qwen/Qwen3-0.6B family.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, qk_norm.
long_500k skipped: pure full attention (DESIGN.md §5).
"""

from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        num_layers=28,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        long_context_ok=False,
    )
