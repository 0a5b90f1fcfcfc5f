"""Hymba (arXiv:2411.13676): hybrid-head blocks — attention and Mamba2-style
SSD heads process the same input in parallel; outputs are normalised and
averaged. 128 learnable meta tokens are prepended to every sequence. Most
layers use sliding-window attention; {first, middle, last} are global.

The PyTorch counterpart of the JAX package's ``src/repro/models/hymba.py``,
with its simplifications (DESIGN.md §5): attention and SSM branches run at
full width and are averaged; caches are per layer (no cross-layer KV
sharing). Attention goes through :func:`attention.gqa_attention`, so a
training pass and a prefill from position 0 run in the hand-written flash
kernels (forward, and backward with grad); decode attends over the cache in
plain torch ops, as the reference does. With ``cfg.remat`` and grad mode on,
each layer of a training pass runs under ``torch.utils.checkpoint``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import resolve_device
from .api import ArchConfig
from .attention import gqa_attention, gqa_init, make_kv_cache
from .build import layer_windows
from .layers import (
    cross_entropy_loss, dense_param, embed_param, generator, rms_norm,
    swiglu_mlp, swiglu_mlp_init,
)
from .ssm import SSDState, ssd, ssd_init, ssd_step


class HymbaCaches(NamedTuple):
    kv: list          # per layer KVCache
    ssm: list         # per layer SSDState


def hymba_init(seed: int, cfg: ArchConfig, device="cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the reference's init distributions; torch's numbers, not JAX's)."""
    device = resolve_device(device)
    gen = generator(seed, device)
    d, dtype = cfg.d_model, cfg.dtype
    meta = torch.randn((cfg.num_meta_tokens, d), generator=gen, device=device,
                       dtype=torch.float32)
    params: dict = {
        "embed": embed_param(gen, cfg.vocab, d, dtype, device),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
        "lm_head": dense_param(gen, d, cfg.vocab, dtype, device),
        "meta_tokens": (meta * 0.02).to(dtype),
    }

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=device)

    params["layers"] = [
        {
            "norm": zeros(),
            "attn": gqa_init(gen, cfg, dtype, device),
            "attn_out_norm": zeros(),
            "ssd": ssd_init(gen, d, cfg.num_heads, cfg.ssm.state_dim, dtype, device),
            "ssd_out_norm": zeros(),
            "ffn_norm": zeros(),
            "mlp": swiglu_mlp_init(gen, d, cfg.d_ff, dtype, device),
        }
        for _ in range(cfg.num_layers)
    ]
    return params


def _layer(lp, x, positions, cfg: ArchConfig, window, kv=None, ssm_state=None,
           start: int | None = None):
    """One hybrid block; returns (x, new KV cache, new SSD state)."""
    h = rms_norm(x, lp["norm"])
    a, new_kv = gqa_attention(lp["attn"], h, positions, cfg, window=window, cache=kv,
                              start=start)
    if x.shape[1] == 1 and ssm_state is not None:
        m, new_ssm = ssd_step(lp["ssd"], h, ssm_state, cfg.num_heads, cfg.ssm.state_dim)
    else:
        m, new_ssm = ssd(lp["ssd"], h, cfg.num_heads, cfg.ssm.state_dim,
                         chunk=cfg.ssm.chunk)
    mixed = 0.5 * (rms_norm(a, lp["attn_out_norm"]) + rms_norm(m, lp["ssd_out_norm"]))
    x = x + mixed
    x = x + swiglu_mlp(lp["mlp"], rms_norm(x, lp["ffn_norm"]))
    return x, new_kv, new_ssm


def _forward(params, cfg: ArchConfig, tokens, caches: HymbaCaches | None = None,
             positions=None):
    b, s = tokens.shape
    x = params["embed"][tokens]
    if s > 1:  # train/prefill: prepend meta tokens
        meta = params["meta_tokens"][None].expand(b, cfg.num_meta_tokens, cfg.d_model)
        x = torch.cat([meta.to(x.dtype), x], dim=1)
    start = None
    if positions is None:
        positions, start = torch.arange(x.shape[1], device=x.device), 0
    windows = layer_windows(cfg, cfg.num_layers)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    new_kv, new_ssm = [], []
    for i, lp in enumerate(params["layers"]):
        window = int(windows[i]) or None
        if caches is None:
            args = (lp, x, positions, cfg, window)
            x, _, nssm = (checkpoint(_layer, *args, use_reentrant=False,
                                     preserve_rng_state=False)
                          if remat else _layer(*args))
            new_kv.append(None)
        else:
            x, nkv, nssm = _layer(lp, x, positions, cfg, window,
                                  caches.kv[i], caches.ssm[i], start)
            new_kv.append(nkv)
        new_ssm.append(nssm)
    return x, (HymbaCaches(new_kv, new_ssm) if caches is not None else None)


def _unembed(params, x):
    return rms_norm(x, params["final_norm"]) @ params["lm_head"]


def hymba_loss(params, cfg: ArchConfig, batch):
    """Mean next-token cross-entropy of the prompt's rows (the meta rows are
    dropped before the head)."""
    x, _ = _forward(params, cfg, batch["tokens"])
    logits = _unembed(params, x[:, cfg.num_meta_tokens:])
    loss = cross_entropy_loss(logits, batch["labels"])
    return loss, {"ce": loss}


def hymba_make_caches(params, cfg: ArchConfig, batch: int, cache_len: int) -> HymbaCaches:
    """A KV cache of ``cache_len + num_meta_tokens`` slots and a zero SSD
    state for each layer."""
    device = params["embed"].device
    dh = cfg.d_model // cfg.num_heads
    kv = [make_kv_cache(cfg, batch, cache_len + cfg.num_meta_tokens, cfg.dtype, device)
          for _ in range(cfg.num_layers)]
    ssm = [SSDState(torch.zeros((batch, cfg.num_heads, cfg.ssm.state_dim, dh),
                                dtype=torch.float32, device=device))
           for _ in range(cfg.num_layers)]
    return HymbaCaches(kv, ssm)


def hymba_decode_step(params, cfg: ArchConfig, token, caches: HymbaCaches, pos: int):
    """One decode step: token [B, 1] at absolute position ``pos`` (the meta
    tokens count: the first generated token after an s-token prompt is at
    ``s + num_meta_tokens``)."""
    positions = torch.tensor([pos], device=token.device)
    x, new_caches = _forward(params, cfg, token, caches, positions)
    return _unembed(params, x)[:, -1], new_caches


def hymba_prefill(params, cfg: ArchConfig, tokens, cache_len: int):
    """The parallel pass over the meta tokens and ``tokens``, writing the
    caches from position 0 (attention in the flash kernel). Only the last
    position is unembedded (the rows are independent)."""
    caches = hymba_make_caches(params, cfg, tokens.shape[0], cache_len)
    x, new_caches = _forward(params, cfg, tokens, caches)
    return _unembed(params, x[:, -1:])[:, -1], new_caches
