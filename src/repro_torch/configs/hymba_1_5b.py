"""hymba-1.5b [hybrid] — arXiv:2411.13676 (parallel attention + mamba heads).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16, 128 meta
tokens, SWA everywhere except {first, middle, last} global layers.
long_500k RUNS: SSM state is O(1) and SWA bounds local caches (DESIGN.md §5).
"""

from ..models.api import ArchConfig, SSMSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab=32001,
        sliding_window=1024,
        window_pattern="hymba",
        ssm=SSMSpec(state_dim=16, chunk=128),
        num_meta_tokens=128,
        long_context_ok=True,
        scan_layers=False,
    )
