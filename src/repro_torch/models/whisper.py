"""Whisper-small backbone (arXiv:2212.04356): encoder-decoder transformer.

The PyTorch counterpart of the JAX package's ``src/repro/models/whisper.py``.
The conv/mel audio frontend is a stub, as in the reference: the model takes
precomputed frame embeddings [batch, frames, d_model]. The backbone:
an encoder with sinusoidal positions and bidirectional attention, a decoder
with learned positions, causal self-attention and cross-attention, GELU
MLPs, pre-LayerNorm and a tied unembedding.

Attention goes through :func:`attention.gqa_attention`. The decoder's causal
self-attention of a training pass, and of a prefill (from position 0),
runs in the hand-written flash kernel (forward; backward with grad), padded
to its block; the encoder's bidirectional passes and the cross-attention
attend in plain torch ops, as every non-causal pass of the port does. With
``cfg.remat`` and grad mode on, each encoder layer and each decoder layer of
a training pass runs under ``torch.utils.checkpoint``.

Decode carries (a) per-layer self-attention KV caches, updated in place, and
(b) per-layer cross-attention K/V computed once from the encoder output at
prefill.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import resolve_device
from .api import ArchConfig
from .attention import clamped_block_index, gqa_attention, gqa_init, make_kv_cache
from .layers import (
    cross_entropy_loss, embed_param, gelu_mlp, gelu_mlp_init, generator, layer_norm,
)


class WhisperCaches(NamedTuple):
    self_kv: list            # per decoder layer KVCache
    cross_kv: list           # per decoder layer (k, v) from the encoder


def _ln_init(d: int, dtype, device) -> dict:
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def _sinusoid(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    return np.concatenate([np.sin(angle), np.cos(angle)], axis=1).astype(np.float32)


def whisper_init(seed: int, cfg: ArchConfig, device="cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the reference's init distributions and keys; torch's numbers, not
    JAX's). The decoder's learned positions hold ``cfg.max_positions``
    rows."""
    device = resolve_device(device)
    gen = generator(seed, device)
    d, dtype = cfg.d_model, cfg.dtype
    pos = torch.randn((cfg.max_positions, d), generator=gen, device=device,
                      dtype=torch.float32)
    params: dict = {
        "embed": embed_param(gen, cfg.vocab, d, dtype, device),
        "pos_embed": (pos * 0.01).to(dtype),
        "enc_final_ln": _ln_init(d, dtype, device),
        "dec_final_ln": _ln_init(d, dtype, device),
        "enc_layers": [],
        "dec_layers": [],
    }
    for _ in range(cfg.num_layers):
        params["enc_layers"].append({
            "ln1": _ln_init(d, dtype, device),
            "attn": gqa_init(gen, cfg, dtype, device),
            "ln2": _ln_init(d, dtype, device),
            "mlp": gelu_mlp_init(gen, d, cfg.d_ff, dtype, device),
        })
    for _ in range(cfg.num_layers):
        params["dec_layers"].append({
            "ln1": _ln_init(d, dtype, device),
            "self_attn": gqa_init(gen, cfg, dtype, device),
            "ln2": _ln_init(d, dtype, device),
            "cross_attn": gqa_init(gen, cfg, dtype, device),
            "ln3": _ln_init(d, dtype, device),
            "mlp": gelu_mlp_init(gen, d, cfg.d_ff, dtype, device),
        })
    return params


def _ln(x, p):
    return layer_norm(x, p["w"], p["b"])


def _enc_layer(lp, x, positions, cfg):
    h, _ = gqa_attention(lp["attn"], _ln(x, lp["ln1"]), positions, cfg, causal=False)
    x = x + h
    return x + gelu_mlp(lp["mlp"], _ln(x, lp["ln2"]))


def whisper_encode(params, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over frame embeddings [b, frames, d_model]."""
    _, f, d = frames.shape
    sin = torch.as_tensor(_sinusoid(f, d), device=frames.device).to(cfg.dtype)
    x = frames.to(cfg.dtype) + sin[None]
    positions = torch.arange(f, device=frames.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["enc_layers"]:
        x = (checkpoint(_enc_layer, lp, x, positions, cfg, use_reentrant=False,
                        preserve_rng_state=False)
             if remat else _enc_layer(lp, x, positions, cfg))
    return _ln(x, params["enc_final_ln"])


def _cross_kv(params_layer, cfg: ArchConfig, enc_out: torch.Tensor):
    b, f, _ = enc_out.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    attn = params_layer["cross_attn"]
    k = (enc_out @ attn["w_k"]).reshape(b, f, hkv, hd).transpose(1, 2)
    v = (enc_out @ attn["w_v"]).reshape(b, f, hkv, hd).transpose(1, 2)
    return k, v


def _dec_layer(lp, x, positions, cfg, cross_kv, cache=None, start: int | None = None):
    """One decoder layer; returns (x, its self-attention cache)."""
    h, new_cache = gqa_attention(lp["self_attn"], _ln(x, lp["ln1"]), positions, cfg,
                                 cache=cache, start=start)
    x = x + h
    h, _ = gqa_attention(lp["cross_attn"], _ln(x, lp["ln2"]), positions, cfg,
                         cross_kv=cross_kv, causal=False)
    x = x + h
    return x + gelu_mlp(lp["mlp"], _ln(x, lp["ln3"])), new_cache


def _dec_train_layer(lp, x, positions, cfg, enc_out):
    """A decoder layer of a training pass, its cross K/V made inside, so
    that remat recomputes them as the reference does."""
    return _dec_layer(lp, x, positions, cfg, _cross_kv(lp, cfg, enc_out))[0]


def whisper_decode_stack(params, cfg: ArchConfig, tokens, enc_out=None, caches=None,
                         positions=None):
    """The decoder: (logits [b, s, vocab], caches). Without ``caches`` (a
    training pass) each layer's cross K/V come from ``enc_out`` and the
    caches returned are None; with them, the self-attention caches are
    written in place and ``caches.cross_kv`` is attended. The learned
    positions are read at ``positions[0]``, clamped as ``dynamic_slice``
    clamps."""
    s = tokens.shape[1]
    start = None
    if positions is None:
        positions, start = torch.arange(s, device=tokens.device), 0
    pos = params["pos_embed"].index_select(
        0, clamped_block_index(positions, params["pos_embed"].shape[0]))
    x = params["embed"][tokens] + pos[None].to(cfg.dtype)
    if caches is None:
        remat = cfg.remat and torch.is_grad_enabled()
        for lp in params["dec_layers"]:
            x = (checkpoint(_dec_train_layer, lp, x, positions, cfg, enc_out,
                            use_reentrant=False, preserve_rng_state=False)
                 if remat else _dec_train_layer(lp, x, positions, cfg, enc_out))
        new_caches = None
    else:
        new_self = []
        for lp, self_c, ckv in zip(params["dec_layers"], caches.self_kv, caches.cross_kv):
            x, nc = _dec_layer(lp, x, positions, cfg, ckv, cache=self_c, start=start)
            new_self.append(nc)
        new_caches = WhisperCaches(new_self, caches.cross_kv)
    x = _ln(x, params["dec_final_ln"])
    return x @ params["embed"].T, new_caches        # tied


def whisper_loss(params, cfg: ArchConfig, batch):
    """Mean next-token cross-entropy (with the z-loss) of the decoder over
    ``batch["tokens"]`` given ``batch["frames"]``; metrics ``ce``."""
    enc_out = whisper_encode(params, cfg, batch["frames"])
    logits, _ = whisper_decode_stack(params, cfg, batch["tokens"], enc_out)
    loss = cross_entropy_loss(logits, batch["labels"])
    return loss, {"ce": loss}


def _self_kv_caches(cfg: ArchConfig, batch: int, cache_len: int, device) -> list:
    """One empty self-attention KV cache of ``cache_len`` per decoder layer."""
    return [make_kv_cache(cfg, batch, cache_len, cfg.dtype, device)
            for _ in range(cfg.num_layers)]


def whisper_make_caches(params, cfg: ArchConfig, batch: int, cache_len: int) -> WhisperCaches:
    device = params["embed"].device
    self_kv = _self_kv_caches(cfg, batch, cache_len, device)
    shape = (batch, cfg.num_kv_heads, cfg.frontend_len, cfg.head_dim)
    cross = [(torch.zeros(shape, dtype=cfg.dtype, device=device),
              torch.zeros(shape, dtype=cfg.dtype, device=device))
             for _ in range(cfg.num_layers)]
    return WhisperCaches(self_kv, cross)


def whisper_decode_step(params, cfg: ArchConfig, token, caches: WhisperCaches, pos: int):
    """One decode step: token [B, 1] at absolute position ``pos``."""
    positions = torch.tensor([pos], device=token.device)
    logits, new_caches = whisper_decode_stack(params, cfg, token, caches=caches,
                                              positions=positions)
    return logits[:, -1], new_caches


def whisper_prefill(params, cfg: ArchConfig, batch, cache_len: int):
    """batch: {frames, tokens}; returns the last logits and the caches: the
    cross K/V from the encoder, then the prompt through the decoder,
    written into self-attention caches of ``cache_len``."""
    enc_out = whisper_encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    self_kv = _self_kv_caches(cfg, tokens.shape[0], cache_len, params["embed"].device)
    cross = [_cross_kv(lp, cfg, enc_out) for lp in params["dec_layers"]]
    logits, new_caches = whisper_decode_stack(params, cfg, tokens,
                                              caches=WhisperCaches(self_kv, cross))
    return logits[:, -1], new_caches
