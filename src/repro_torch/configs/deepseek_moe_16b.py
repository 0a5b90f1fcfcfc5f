"""deepseek-moe-16b [moe] — arXiv:2401.06066 (fine-grained experts).

28L d_model=2048 16H (kv=16) moe_d_ff=1408 vocab=102400, 2 shared + 64 routed
top-6 (softmax), first layer dense (d_ff=10944). long_500k skipped: full
attention (DESIGN.md §5).
"""

from ..models.api import ArchConfig, MoESpec


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=10944,              # dense first layer
        moe_d_ff=1408,
        vocab=102400,
        num_dense_layers=1,
        moe=MoESpec(
            num_experts=64,
            top_k=6,
            num_shared=2,
            score_fn="softmax",
            normalize_gates=False,
            capacity_factor=1.25,
            aux_loss_coef=0.001,
        ),
        long_context_ok=False,
    )
