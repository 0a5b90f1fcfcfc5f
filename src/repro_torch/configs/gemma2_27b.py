"""gemma2-27b [dense] — arXiv:2408.00118.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; local/global
alternating, softcaps, sandwich norms, GeGLU, tied embeddings; query scale
sqrt(d_model/heads) per the tech report. long_500k RUNS (see gemma2-9b).
"""

from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b",
        family="dense",
        num_layers=46,
        d_model=4608,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab=256000,
        sliding_window=4096,
        window_pattern="alternating",
        attn_softcap=50.0,
        final_softcap=30.0,
        sandwich_norm=True,
        mlp_kind="geglu",
        tie_embeddings=True,
        embed_scale=True,
        attn_scale=(4608 / 32) ** -0.5,
        long_context_ok=True,
    )
