"""whisper-small [audio] — arXiv:2212.04356, encoder-decoder.

12L (x2: encoder + decoder) d_model=768 12H (MHA) d_ff=3072 vocab=51865.
Conv/mel frontend stubbed: input_specs supply frame embeddings [B, 1500, 768].
Learned decoder positions sized for the serving shapes. long_500k skipped:
full attention enc-dec (DESIGN.md §5).
"""

from ..models.api import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab=51865,
        mlp_kind="gelu",
        use_rope=False,
        frontend="audio",
        frontend_len=1500,
        max_positions=32_768 + 8,   # decode_32k cache
        long_context_ok=False,
        scan_layers=False,          # layers as a python loop: cost_analysis exact
    )
