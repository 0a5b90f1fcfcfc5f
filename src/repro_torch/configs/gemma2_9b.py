"""gemma2-9b [dense] — arXiv:2408.00118.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000; local(4096)/global
alternating, attn softcap 50, final softcap 30, sandwich norms, GeGLU, tied
embeddings, embed scaling. long_500k RUNS: alternating local layers give the
sub-quadratic component; global-layer caches shard over 'model' (DESIGN.md §5).
"""

from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab=256000,
        sliding_window=4096,
        window_pattern="alternating",
        attn_softcap=50.0,
        final_softcap=30.0,
        sandwich_norm=True,
        mlp_kind="geglu",
        tie_embeddings=True,
        embed_scale=True,
        attn_scale=256.0**-0.5,
        long_context_ok=True,
    )
