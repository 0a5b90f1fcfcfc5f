"""xlstm-125m [ssm] — arXiv:2405.04517 (sLSTM + mLSTM blocks).

12L d_model=768 4H d_ff=0 (mixing blocks only) vocab=50304; even layers mLSTM
(chunk-parallel), odd layers sLSTM (sequential scan). long_500k RUNS: decode
carries O(1) recurrent state (DESIGN.md §5).
"""

from ..models.api import ArchConfig, SSMSpec


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab=50304,
        use_rope=False,
        ssm=SSMSpec(state_dim=0, chunk=128),
        long_context_ok=True,
        scan_layers=False,
    )
