"""build_model: ArchConfig -> ModelSpec, for every family.

The PyTorch counterpart of the JAX package's ``src/repro/models/zoo.py``:
``family == "dense"`` (qwen3-0.6b, gemma2-9b, gemma2-27b,
mistral-nemo-12b), ``"moe"`` (deepseek-moe-16b, deepseek-v3-671b: MoE
layers, MLA, multi-token prediction), ``"vlm"`` (paligemma-3b: the decoder
LM with a prefix of patch embeddings under prefix-LM masking), ``"audio"``
(whisper-small: encoder-decoder), ``"ssm"`` (xlstm-125m: mLSTM / sLSTM
blocks) and ``"hybrid"`` (hymba-1.5b: attention and SSD heads in parallel,
meta tokens). An unknown family raises ``ValueError``.
"""

from __future__ import annotations

import torch

from . import build as lm
from . import hymba as hy
from . import whisper as wh
from . import xlstm as xl
from .api import ArchConfig, ModelSpec, ShapeSpec


def train_input_specs(cfg: ArchConfig, shape: ShapeSpec, device="meta") -> dict:
    """A training batch of ``shape`` as empty tensors on ``device`` (on
    ``meta``, shapes and dtypes only): the counterpart of the reference's
    ``ShapeDtypeStruct`` stand-ins that its dry-run lowers against. Tokens
    and labels int32 [b, s]; an audio model's frames or a vision model's
    prefix embeddings f32 [b, frontend_len, d_model]."""
    b, s = shape.global_batch, shape.seq_len
    specs = {k: torch.empty((b, s), dtype=torch.int32, device=device)
             for k in ("tokens", "labels")}
    extra = {"audio": "frames", "vision": "prefix_embeds"}.get(cfg.frontend)
    if extra:
        specs[extra] = torch.empty((b, cfg.frontend_len, cfg.d_model),
                                   dtype=torch.float32, device=device)
    return specs


def _tokens(batch):
    return batch["tokens"] if isinstance(batch, dict) else batch


def build_model(cfg: ArchConfig, *, mesh=None, data_axes=("data",),
                model_axis: str = "model") -> ModelSpec:
    """The surface of ``cfg``'s model: ``init(seed, device)``,
    ``loss_fn(params, batch) -> (loss, metrics)``, ``prefill(params,
    batch, cache_len)`` (tokens, or a dict with ``tokens``, and for the
    audio family ``frames``), ``decode_step(params, token, caches, pos)``
    and ``make_caches(params, batch, cache_len)``.

    With a ``mesh`` (a ``DeviceMesh`` this rank is in), ``loss_fn`` takes
    placed parameters (DTensors under ``sharding.param_shardings``) and this
    rank's batch shard, and returns this rank's loss
    (``models/sharded.py``); the dense, MoE and vlm families run tensor-
    and expert-parallel as the reference's ``build_model(cfg, mesh=...)``
    does, the others on whole weights. ``prefill`` and ``decode_step`` take
    the whole token batch and return the whole logits on every rank, each
    rank on its rows (where the data axes divide the batch); the decoder
    LM's caches are placed as the reference's ``cache_shardings`` places
    its stacked caches (``models/sharded.py``), the other families' hold
    this rank's rows."""
    if mesh is not None:
        return _sharded(build_model(cfg), mesh, data_axes, model_axis)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        def make_caches(params, batch, cache_len):
            extra = cfg.frontend_len + cfg.num_meta_tokens
            return lm.lm_make_caches(params, cfg, batch, cache_len + extra)

        # prefill is text only and sizes its caches itself, as the
        # reference's lm_prefill does (without make_caches' prefix room)
        return ModelSpec(
            cfg=cfg,
            init=lambda seed, device="cuda": lm._lm_init(seed, cfg, device),
            loss_fn=lambda p, b: lm.lm_loss(p, cfg, b),
            prefill=lambda p, b, n: lm.lm_prefill(p, cfg, _tokens(b), n),
            decode_step=lambda p, t, c, pos: lm.lm_decode_step(p, cfg, t, c, pos),
            make_caches=make_caches,
            param_count=param_count,
        )
    if fam == "audio":
        return ModelSpec(
            cfg=cfg,
            init=lambda seed, device="cuda": wh.whisper_init(seed, cfg, device),
            loss_fn=lambda p, b: wh.whisper_loss(p, cfg, b),
            prefill=lambda p, b, n: wh.whisper_prefill(p, cfg, b, n),
            decode_step=lambda p, t, c, pos: wh.whisper_decode_step(p, cfg, t, c, pos),
            make_caches=lambda p, b, n: wh.whisper_make_caches(p, cfg, b, n),
            param_count=param_count,
        )
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
    raise ValueError(f"unknown family {fam}")


def _sharded(spec: ModelSpec, mesh, data_axes, model_axis) -> ModelSpec:
    """``spec`` on this rank's shards of ``mesh``: the decoder LM's loss and
    serving tensor- and expert-parallel, any other family's on whole
    weights (each gathered over its sharded axes; the data-parallel form,
    as the reference's builders of those families take no mesh)."""
    from ..sharding.rules import P
    from ..sharding.spmd import Spmd, all_gather, chunk, to_spec
    from ..tree import tree_map
    from .sharded import TensorParallel, rows_split

    spmd = Spmd(mesh, data_axes=data_axes, model_axis=model_axis)
    cfg = spec.cfg
    if cfg.family in ("dense", "moe", "vlm"):
        tp = TensorParallel(cfg, spmd)
        extra = cfg.frontend_len + cfg.num_meta_tokens
        return ModelSpec(
            cfg=cfg,
            init=spec.init,
            loss_fn=lambda p, b: lm.lm_loss(p, cfg, b, tp=tp),
            prefill=lambda p, b, n: lm.lm_prefill(p, cfg, _tokens(b), n, tp=tp),
            decode_step=lambda p, t, c, pos: lm.lm_decode_step(p, cfg, t, c, pos, tp=tp),
            make_caches=lambda p, b, n: lm.lm_make_caches(p, cfg, b, n + extra, tp=tp),
            param_count=spec.param_count,
        )

    def whole(params):
        return tree_map(lambda d: to_spec(d, P(), spmd), params)

    def rows(batch):
        # this rank's rows of a whole batch (a tensor, or a dict of them)
        n = (batch if torch.is_tensor(batch) else batch["tokens"]).shape[0]
        if not rows_split(spmd, n):
            return batch, False
        return tree_map(lambda t: chunk(t, spmd, data_axes, 0), batch), True

    def serve(fn, params, batch, *args):
        local, split = rows(batch)
        logits, caches = fn(whole(params), local, *args)
        return (all_gather(logits, spmd, data_axes, 0) if split else logits), caches

    return ModelSpec(
        cfg=cfg,
        init=spec.init,
        loss_fn=lambda p, b: spec.loss_fn(whole(p), b),
        prefill=lambda p, b, n: serve(spec.prefill, p, b, n),
        decode_step=lambda p, t, c, pos: serve(spec.decode_step, p, t, c, pos),
        make_caches=lambda p, b, n: spec.make_caches(
            whole(p), b // spmd.size(data_axes) if rows_split(spmd, b) else b, n),
        param_count=spec.param_count,
    )


def param_count(params) -> int:
    """Elements in a parameter tree of dicts and lists of tensors."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()
