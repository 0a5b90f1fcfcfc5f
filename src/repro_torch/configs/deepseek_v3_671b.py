"""deepseek-v3-671b [moe] — arXiv:2412.19437.

61L d_model=7168 128H (MLA) moe_d_ff=2048 vocab=129280, 1 shared + 256 routed
top-8 (sigmoid scores, gate-normalised), first 3 layers dense (d_ff=18432),
MTP enabled. long_500k skipped: MLA is full attention (DESIGN.md §5).
"""

from ..models.api import ArchConfig, MLASpec, MoESpec


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=18432,              # dense leading layers
        moe_d_ff=2048,
        vocab=129280,
        num_dense_layers=3,
        moe=MoESpec(
            num_experts=256,
            top_k=8,
            num_shared=1,
            score_fn="sigmoid",
            normalize_gates=True,
            routed_scale=2.5,
            capacity_factor=1.25,
            aux_loss_coef=0.0001,
        ),
        mla=MLASpec(q_lora=1536, kv_lora=512, rope_dim=64, qk_nope_dim=128, v_dim=128),
        mtp=True,
        rope_theta=10_000.0,
        long_context_ok=False,
    )
