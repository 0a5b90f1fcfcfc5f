"""paligemma-3b [vlm] — arXiv:2407.07726 (SigLIP + gemma backbone).

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216. SigLIP vision tower
stubbed: input_specs supply 256 patch embeddings [B, 256, 2048]; prefix-LM
masking (bidirectional over image+prompt prefix). long_500k skipped: full
attention (DESIGN.md §5).
"""

from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="paligemma-3b",
        family="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=257216,
        mlp_kind="geglu",
        tie_embeddings=True,
        embed_scale=True,
        frontend="vision",
        frontend_len=256,
        prefix_lm=True,
        long_context_ok=False,
    )
