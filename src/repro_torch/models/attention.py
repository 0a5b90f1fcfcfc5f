"""Attention for the model zoo: GQA (+qk-norm, sliding window, softcap)
and Multi-head Latent Attention (DeepSeek-V2/V3 MLA).

The PyTorch counterpart of the JAX package's
``src/repro/models/attention.py``. Every causal pass with more than one
query, no ``cross_kv`` and no ``prefix_len`` whose keys are its own (a
parallel forward without caches, as in training, and a prefill that writes
its cache from position 0) computes attention with the hand-written
flash-attention kernel (``kernels/flash_attention.py``), over the prompt's
own k/v; with grad on, its gradient runs in the hand-written backward
kernel. That equals the reference, which attends over the whole cache with
a ``valid`` mask: keys past the prompt are masked both by ``valid`` and by
causality. Decode (one query), a prefill at a later offset of its cache
(which attends over the cache's earlier entries too) and the other passes
attend in plain torch ops over the whole cache, as the reference does
outside any Pallas kernel.

The cache is updated in place (the reference returns a new one): a decode
step then writes one position per layer instead of copying the whole cache.
A pass of ``s`` rows writes them at ``positions[0]`` clamped into ``[0,
cache_len - s]``, as the reference's ``dynamic_update_slice`` does
(:func:`clamped_block_index`): the vlm family's served decode runs past the
end of its cache, and each step then overwrites the last slot. Rotary
angles and the ``valid`` mask keep the unclamped positions.

MLA attends in plain torch ops on every pass, as the reference does: the
flash kernel takes one head dim for q, k and v, and MLA's v dim (128 for
V3) is not its qk dim (192).

Cache layouts (decode):
  GQA: k, v [batch, kv_heads, cache_len, head_dim]
  MLA: c_kv [batch, cache_len, kv_lora + rope_dim] (the compressed latent
       and the shared rope key)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.flash_attention import flash_attention_padded
from .layers import dense_param, rms_norm, rope, softcap


class KVCache(NamedTuple):
    k: torch.Tensor
    v: torch.Tensor


class MLACache(NamedTuple):
    c_kv: torch.Tensor   # [batch, cache, kv_lora + rope_dim]


def gqa_init(gen: torch.Generator, cfg, layer_dtype, device) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "w_q": dense_param(gen, d, hq * hd, layer_dtype, device),
        "w_k": dense_param(gen, d, hkv * hd, layer_dtype, device),
        "w_v": dense_param(gen, d, hkv * hd, layer_dtype, device),
        "w_o": dense_param(gen, hq * hd, d, layer_dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=layer_dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=layer_dtype, device=device)
    return p


def clamped_block_index(positions: torch.Tensor, length: int) -> torch.Tensor:
    """The indices of a block of ``len(positions)`` rows starting at
    ``positions[0]`` in an axis of ``length``, the start clamped into ``[0,
    length - rows]`` as ``jax.lax.dynamic_update_slice`` (a cache write)
    and ``dynamic_slice`` (a read) clamp it. Stays on the device."""
    s = positions.shape[0]
    start = positions[0].clamp(0, max(length - s, 0))
    return start + torch.arange(s, device=positions.device)


def _mask_bias(q_pos, k_pos, *, causal: bool, window, prefix_len=None) -> torch.Tensor:
    """Additive mask [q, k] in f32 (0 or -1e30); ``window`` <= 0 means no
    window; ``prefix_len`` makes the prefix bidirectional (prefix-LM)."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None and window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    if prefix_len is not None:
        ok |= (q_pos[:, None] < prefix_len) & (k_pos[None, :] < prefix_len)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, -1e30)


_BLOCKED_ATTN_THRESHOLD = 16 * 2**20   # s_q * s_k above which we block
_Q_BLOCK = 512


def _scores_attention(qg, k, v, q_pos, k_pos, *, scale, attn_softcap, causal,
                      window, prefix_len, valid):
    """Direct softmax attention in f32. qg: [b, hkv, g, s, d]; k, v:
    [b, hkv, t, d]; ``valid`` [t] masks cache slots not yet written."""
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    scores = softcap(scores, attn_softcap)
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=window,
                      prefix_len=prefix_len)
    if valid is not None:
        bias = bias + torch.where(valid, 0.0, -1e30)[None, :]
    probs = torch.softmax(scores + bias, dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())


def _blocked_scores_attention(qg, k, v, q_pos, k_pos, *, scale, attn_softcap,
                              causal, window, prefix_len, valid):
    """:func:`_scores_attention` one block of ``_Q_BLOCK`` queries at a time,
    so only [q_block, s_k] scores exist at once (the reference's scan over
    query blocks, as a Python loop)."""
    s = qg.shape[3]
    return torch.cat([
        _scores_attention(qg[:, :, :, i:i + _Q_BLOCK], k, v,
                          q_pos[i:i + _Q_BLOCK], k_pos, scale=scale,
                          attn_softcap=attn_softcap, causal=causal,
                          window=window, prefix_len=prefix_len, valid=valid)
        for i in range(0, s, _Q_BLOCK)
    ], dim=3)


def gqa_attention(
    params: dict,
    x: torch.Tensor,               # [batch, seq, d_model]
    positions: torch.Tensor,       # [seq] (absolute)
    cfg,
    *,
    causal: bool = True,
    window: int | None = None,     # None | int (<= 0 => global)
    prefix_len: int | None = None,  # prefix-LM bidirectional region
    cache: KVCache | None = None,  # append & attend over cache
    cross_kv: tuple | None = None,  # encoder K/V for cross-attention
) -> tuple[torch.Tensor, KVCache | None]:
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["w_q"]).reshape(b, s, hq, hd).transpose(1, 2)
    if cross_kv is None:
        k = (x @ params["w_k"]).reshape(b, s, hkv, hd).transpose(1, 2)
        v = (x @ params["w_v"]).reshape(b, s, hkv, hd).transpose(1, 2)
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        if cross_kv is None:
            k = rms_norm(k, params["k_norm"])
    if cfg.use_rope and cross_kv is None:
        q = rope(q, positions[None, None, :], theta=cfg.rope_theta)
        k = rope(k, positions[None, None, :], theta=cfg.rope_theta)
    scale = cfg.head_dim**-0.5 if cfg.attn_scale is None else cfg.attn_scale
    prefill = s > 1 and causal and cross_kv is None and prefix_len is None

    new_cache = None
    if cache is not None and cross_kv is None:
        # write k/v at the pass's positions (the block's start clamped)
        idx = clamped_block_index(positions, cache.k.shape[2])
        cache.k.index_copy_(2, idx, k)
        cache.v.index_copy_(2, idx, v)
        new_cache = cache
        # the kernel attends over the pass's own k/v: a prefill from
        # position 0 sees nothing else of the cache, a later one does
        prefill = prefill and int(positions[0]) == 0

    if prefill:
        out = flash_attention_padded(
            q, k, v, sm_scale=scale,
            window=window if window is not None and window > 0 else None,
            softcap=cfg.attn_softcap,
        )
    else:
        if new_cache is not None:
            # decode, or a prefill at an offset: attend over the whole
            # cache, unwritten slots masked
            k, v = cache.k, cache.v
            k_pos = torch.arange(k.shape[2], device=x.device)
            valid = k_pos <= positions[-1]
        else:
            k_pos = (positions if cross_kv is None
                     else torch.arange(k.shape[2], device=x.device))
            valid = None
        group = hq // k.shape[1]
        qg = q.reshape(b, k.shape[1], group, s, hd)
        attend = (_blocked_scores_attention
                  if s * k.shape[2] >= _BLOCKED_ATTN_THRESHOLD and s > 1
                  else _scores_attention)
        out = attend(
            qg, k, v, positions, k_pos, scale=scale,
            attn_softcap=cfg.attn_softcap, causal=causal and cross_kv is None,
            window=window if cross_kv is None else None,
            prefix_len=prefix_len if cross_kv is None else None, valid=valid,
        ).reshape(b, hq, s, hd)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return out.to(x.dtype) @ params["w_o"], new_cache


def make_kv_cache(cfg, batch: int, cache_len: int, dtype, device) -> KVCache:
    shape = (batch, cfg.num_kv_heads, cache_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# --------------------------------------------------------------------- MLA

def mla_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    d, h, m = cfg.d_model, cfg.num_heads, cfg.mla
    qk_head = m.qk_nope_dim + m.rope_dim
    return {
        # query path (low-rank)
        "w_dq": dense_param(gen, d, m.q_lora, dtype, device),
        "q_norm": torch.zeros((m.q_lora,), dtype=dtype, device=device),
        "w_uq": dense_param(gen, m.q_lora, h * qk_head, dtype, device),
        # kv path (compressed latent + decoupled rope key)
        "w_dkv": dense_param(gen, d, m.kv_lora + m.rope_dim, dtype, device),
        "kv_norm": torch.zeros((m.kv_lora,), dtype=dtype, device=device),
        "w_uk": dense_param(gen, m.kv_lora, h * m.qk_nope_dim, dtype, device),
        "w_uv": dense_param(gen, m.kv_lora, h * m.v_dim, dtype, device),
        "w_o": dense_param(gen, h * m.v_dim, d, dtype, device),
    }


def mla_attention(
    params: dict,
    x: torch.Tensor,               # [batch, seq, d_model]
    positions: torch.Tensor,       # [seq] (absolute)
    cfg,
    *,
    cache: MLACache | None = None,  # append & attend over cache
) -> tuple[torch.Tensor, MLACache | None]:
    """DeepSeek MLA: queries and keys split into a latent 'nope' part and a
    rope part whose key is shared by every head; only the compressed latent
    and the rope key are cached, written at ``positions`` in place."""
    b, s, _ = x.shape
    h, m = cfg.num_heads, cfg.mla

    cq = rms_norm(x @ params["w_dq"], params["q_norm"])
    q = (cq @ params["w_uq"]).reshape(b, s, h, m.qk_nope_dim + m.rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = rope(q_rope.transpose(1, 2), positions[None, None, :],
                  theta=cfg.rope_theta).transpose(1, 2)

    ckv_full = x @ params["w_dkv"]                      # [b, s, kv_lora+rope]
    c_kv, k_rope = ckv_full[..., :m.kv_lora], ckv_full[..., m.kv_lora:]
    k_rope = rope(k_rope[:, None], positions[None, None, :],
                  theta=cfg.rope_theta)[:, 0]           # [b, s, rope] shared

    new_cache = None
    if cache is not None:
        cache.c_kv.index_copy_(1, clamped_block_index(positions, cache.c_kv.shape[1]),
                               torch.cat([c_kv, k_rope], dim=-1))
        new_cache = cache
        c_kv, k_rope = cache.c_kv[..., :m.kv_lora], cache.c_kv[..., m.kv_lora:]
        k_pos = torch.arange(cache.c_kv.shape[1], device=x.device)
        valid = k_pos <= positions[-1]
    else:
        k_pos = positions
        valid = None

    c_kv = rms_norm(c_kv, params["kv_norm"])
    t = c_kv.shape[1]
    k_nope = (c_kv @ params["w_uk"]).reshape(b, t, h, m.qk_nope_dim)
    v = (c_kv @ params["w_uv"]).reshape(b, t, h, m.v_dim)

    scale = (m.qk_nope_dim + m.rope_dim) ** -0.5
    if s * t >= _BLOCKED_ATTN_THRESHOLD and s > 1:
        # fold the shared rope key into the head dim and reuse the blocked path
        q_cat = torch.cat([q_nope, q_rope], dim=-1)               # [b,s,h,dk]
        k_cat = torch.cat(
            [k_nope, k_rope[:, :, None].expand(b, t, h, m.rope_dim)], dim=-1)
        out = _blocked_scores_attention(
            q_cat.transpose(1, 2)[:, :, None], k_cat.transpose(1, 2),
            v.transpose(1, 2), positions, k_pos, scale=scale,
            attn_softcap=None, causal=True, window=None, prefix_len=None,
            valid=valid,
        )                                                         # [b,h,1,s,vd]
        out = out[:, :, 0].transpose(1, 2)                        # [b,s,h,vd]
    else:
        # the reference's (nope + rope) * scale + bias, in place: at a
        # 2048-token prefill of V3 each [b, h, s, t] f32 term is 8.7 GB
        scores = torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
        scores.add_(torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float()))
        scores.mul_(scale)
        bias = _mask_bias(positions, k_pos, causal=True, window=None)
        if valid is not None:
            bias = bias + torch.where(valid, 0.0, -1e30)[None, :]
        probs = torch.softmax(scores.add_(bias), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    out = out.reshape(b, s, h * m.v_dim).to(x.dtype)
    return out @ params["w_o"], new_cache


def make_mla_cache(cfg, batch: int, cache_len: int, dtype, device) -> MLACache:
    m = cfg.mla
    return MLACache(torch.zeros((batch, cache_len, m.kv_lora + m.rope_dim),
                                dtype=dtype, device=device))
