"""build_model: ArchConfig -> ModelSpec, for the dense, MoE, SSM and hybrid
families.

The PyTorch counterpart of the JAX package's ``src/repro/models/zoo.py``.
``family == "dense"`` (qwen3-0.6b, gemma2-9b, gemma2-27b,
mistral-nemo-12b), ``family == "moe"`` (deepseek-moe-16b,
deepseek-v3-671b: MoE layers, MLA, multi-token prediction), ``family ==
"ssm"`` (xlstm-125m: mLSTM / sLSTM blocks) and ``family == "hybrid"``
(hymba-1.5b: attention and SSD heads in parallel, meta tokens) are ported;
the ``vlm`` and ``audio`` families raise ``NotImplementedError`` (ROADMAP
queue 1, "MLA, MoE and the other LM families").
"""

from __future__ import annotations

from . import build as lm
from . import hymba as hy
from . import xlstm as xl
from .api import ArchConfig, ModelSpec
from .attention import NOT_PORTED


def _tokens(batch):
    return batch["tokens"] if isinstance(batch, dict) else batch


def build_model(cfg: ArchConfig) -> ModelSpec:
    """The surface of ``cfg``'s model: ``init(seed, device)``,
    ``loss_fn(params, batch) -> (loss, metrics)``, ``prefill(params,
    tokens, cache_len)``, ``decode_step(params, token, caches, pos)`` and
    ``make_caches(params, batch, cache_len)``."""
    fam = cfg.family
    if fam == "ssm":
        return ModelSpec(
            cfg=cfg,
            init=lambda seed, device="cuda": xl.xlstm_init(seed, cfg, device),
            loss_fn=lambda p, b: xl.xlstm_loss(p, cfg, b),
            prefill=lambda p, b, n: xl.xlstm_prefill(p, cfg, _tokens(b)),
            decode_step=lambda p, t, c, pos: xl.xlstm_decode_step(p, cfg, t, c, pos),
            make_caches=lambda p, b, n: xl.xlstm_make_states(p, cfg, b),
            param_count=param_count,
        )
    if fam == "hybrid":
        return ModelSpec(
            cfg=cfg,
            init=lambda seed, device="cuda": hy.hymba_init(seed, cfg, device),
            loss_fn=lambda p, b: hy.hymba_loss(p, cfg, b),
            prefill=lambda p, b, n: hy.hymba_prefill(p, cfg, _tokens(b), n),
            decode_step=lambda p, t, c, pos: hy.hymba_decode_step(p, cfg, t, c, pos),
            make_caches=lambda p, b, n: hy.hymba_make_caches(p, cfg, b, n),
            param_count=param_count,
        )
    if fam not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {fam!r} is not ported yet: {NOT_PORTED}")
    lm.check_ported(cfg)

    def init(seed, device="cuda"):
        return lm._lm_init(seed, cfg, device)

    def loss_fn(params, batch):
        return lm.lm_loss(params, cfg, batch)

    def prefill(params, batch, cache_len):
        return lm.lm_prefill(params, cfg, _tokens(batch), cache_len)

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
