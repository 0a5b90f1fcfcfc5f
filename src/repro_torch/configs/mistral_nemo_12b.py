"""mistral-nemo-12b [dense] — hf:mistralai/Mistral-Nemo-Base-2407 (128k ctx).

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim=128.
long_500k skipped: pure full attention (DESIGN.md §5).
"""

from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mistral-nemo-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=131072,
        rope_theta=1_000_000.0,
        long_context_ok=False,
    )
