"""Architecture config + model API for the model zoo (pure data).

A copy of the JAX package's ``src/repro/models/api.py``: every architecture
is described by an :class:`ArchConfig` (built in ``configs/``) and
materialised by ``models.zoo.build_model()`` into a :class:`ModelSpec`
exposing, in this package:

    init(seed, device)        -> params (nested dicts and lists of tensors)
    prefill(params, tokens, cache_len) -> (logits_last, caches)  [inference]
    decode_step(params, tok, caches, pos) -> (logits, caches)    [inference]
    make_caches(params, batch, cache_len) -> caches
    loss_fn(params, batch)    -> (loss, metrics)                    [training]

``input_specs`` stays ``None``, as in the reference: the dry-run builds its
inputs with ``zoo.train_input_specs``. ``dtype``
holds a torch dtype: bf16 by default, f32 in :meth:`ArchConfig.reduced`.

Shapes: each arch owns the assignment's four shapes; `shapes()` applies the
skip policy (no long_500k for pure full-attention archs — see DESIGN.md §5).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    num_shared: int = 0
    score_fn: str = "softmax"        # "softmax" | "sigmoid" (deepseek-v3)
    normalize_gates: bool = True
    routed_scale: float = 1.0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MLASpec:
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    qk_nope_dim: int = 128
    v_dim: int = 128


@dataclass(frozen=True)
class SSMSpec:
    state_dim: int = 16
    chunk: int = 128


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


LM_SHAPES = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // num_heads
    # attention options
    qk_norm: bool = False
    use_rope: bool = True
    rope_theta: float = 10_000.0
    attn_softcap: float | None = None
    attn_scale: float | None = None
    final_softcap: float | None = None
    sliding_window: int | None = None
    # per-layer window pattern: "none" | "alternating" (gemma2) | "hymba"
    window_pattern: str = "none"
    sandwich_norm: bool = False    # gemma2 post-norms
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma: x *= sqrt(d)
    mlp_kind: str = "swiglu"       # swiglu | gelu
    # family extensions
    moe: MoESpec | None = None
    moe_d_ff: int = 0
    num_dense_layers: int = 0      # leading dense layers in MoE models
    mla: MLASpec | None = None
    ssm: SSMSpec | None = None
    mtp: bool = False              # deepseek-v3 multi-token prediction
    mtp_weight: float = 0.3
    # frontends (stubs provide precomputed embeddings via input_specs)
    frontend: str | None = None    # None | "audio" | "vision"
    frontend_len: int = 0          # frames/patches
    num_meta_tokens: int = 0       # hymba learnable prefix
    prefix_lm: bool = False        # bidirectional attention over the prefix
    max_positions: int = 0         # learned-position table size (whisper)
    # runtime
    dtype: Any = torch.bfloat16
    long_context_ok: bool = False  # may run long_500k (sub-quadratic story)
    remat: bool = True
    scan_layers: bool = True
    activation_constraints: bool = True  # per-layer with_sharding_constraint
    # full-EP serving mode: experts sharded over every mesh axis (1/device at
    # 256 experts x 256 chips), weights stationary, the (tiny) decode
    # activations replicated into the island instead of gathering weights
    ep_over_data: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def shapes(self) -> list[ShapeSpec]:
        out = []
        for s in LM_SHAPES:
            if s.name == "long_500k" and not self.long_context_ok:
                continue
            out.append(s)
        return out

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return replace(
            self,
            num_layers=min(self.num_layers, 2 if self.num_dense_layers == 0 else 2 + self.num_dense_layers),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            moe_d_ff=128 if self.moe else 0,
            vocab=512,
            num_dense_layers=min(self.num_dense_layers, 1),
            # capacity_factor generous so smoke tests are drop-free (capacity
            # dropping is exercised explicitly in tests/test_models.py)
            moe=replace(self.moe, num_experts=8, top_k=2, capacity_factor=8.0)
            if self.moe
            else None,
            mla=MLASpec(q_lora=64, kv_lora=32, rope_dim=16, qk_nope_dim=32, v_dim=32)
            if self.mla
            else None,
            ssm=replace(self.ssm, chunk=16) if self.ssm else None,
            sliding_window=16 if self.sliding_window else None,
            frontend_len=16 if self.frontend else 0,
            num_meta_tokens=8 if self.num_meta_tokens else 0,
            max_positions=128 if self.max_positions else 0,
            dtype=torch.float32,
            scan_layers=False,
        )


@dataclass
class ModelSpec:
    cfg: ArchConfig
    init: Callable
    loss_fn: Callable | None = None
    prefill: Callable | None = None
    decode_step: Callable | None = None
    make_caches: Callable | None = None
    input_specs: Callable | None = None
    param_count: Callable | None = None
