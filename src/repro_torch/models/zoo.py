"""build_model: ArchConfig -> ModelSpec, for the dense and MoE families.

The PyTorch counterpart of the JAX package's ``src/repro/models/zoo.py``.
``family == "dense"`` (qwen3-0.6b, gemma2-9b, gemma2-27b,
mistral-nemo-12b) and ``family == "moe"`` (deepseek-moe-16b,
deepseek-v3-671b: MoE layers, MLA, multi-token prediction) are ported; the
``vlm``, ``audio``, ``ssm`` and ``hybrid`` families raise
``NotImplementedError`` (ROADMAP queue 1, "MLA, MoE and the other LM
families").
"""

from __future__ import annotations

from . import build as lm
from .api import ArchConfig, ModelSpec
from .attention import NOT_PORTED

def build_model(cfg: ArchConfig) -> ModelSpec:
    """The surface of ``cfg``'s model: ``init(seed, device)``,
    ``loss_fn(params, batch) -> (loss, metrics)``, ``prefill(params,
    tokens, cache_len)``, ``decode_step(params, token, caches, pos)`` and
    ``make_caches(params, batch, cache_len)``."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: {NOT_PORTED}")
    lm.check_ported(cfg)

    def init(seed, device="cuda"):
        return lm._lm_init(seed, cfg, device)

    def loss_fn(params, batch):
        return lm.lm_loss(params, cfg, batch)

    def prefill(params, batch, cache_len):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return lm.lm_prefill(params, cfg, tokens, cache_len)

    def decode_step(params, token, caches, pos):
        return lm.lm_decode_step(params, cfg, token, caches, pos)

    def make_caches(params, batch, cache_len):
        return lm.lm_make_caches(params, cfg, batch, cache_len)

    return ModelSpec(cfg=cfg, init=init, loss_fn=loss_fn, prefill=prefill,
                     decode_step=decode_step, make_caches=make_caches,
                     param_count=param_count)


def param_count(params) -> int:
    """Elements in a parameter tree of dicts and lists of tensors."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()
