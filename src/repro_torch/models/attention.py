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

On a mesh (``models/sharded.py``) a layer's cache is a :class:`PlacedCache`:
this rank's slots of it, under the placement the reference's
``cache_shardings`` gives the stacked cache (``sharding/rules.py``). The
rows and heads of a pass are this rank's (``tp``'s), the cache holds every
row and head. Each pass gathers its new k/v (or latents) over the axes
that split rows or heads, and writes the slots of the block this rank
holds (a static range: the caller passes the block's first position
``start`` as a Python int). A cache every rank holds whole is attended as
on one device, over its rows and heads of this rank. A cache spread over
ranks (its layers over the data axes, its slots over any axes) is attended
in parts: decode gathers the query over the axes that split rows or heads,
each rank takes the partial softmax (max, sum, weighted values) of every
row over the slots it holds (a rank with none gives max -inf, sum 0), and
``sharding.spmd.combine_softmax`` combines the parts over the axes that
spread the cache; each rank keeps its own rows and heads. A prefill from
position 0 attends over its own k/v (the flash kernel for GQA), which
needs no slot of the cache.

``start``, the first position as a Python int, keeps the choice of the
kernel path static: without it the position is read back from the device.
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


class PlacedCache(NamedTuple):
    """A layer's cache on one rank of a mesh: ``cache`` holds slots
    ``[slot0, slot0 + n)`` of a cache of ``length`` slots, every row and
    head (n is 0 on a rank that holds none of the layer); ``split`` names
    the mesh axes that spread the layer's slots over ranks (none when each
    rank holds the whole cache)."""

    cache: KVCache | MLACache
    slot0: int
    length: int
    split: tuple


def _write_placed(placed: PlacedCache, dst: torch.Tensor, src: torch.Tensor,
                  dim: int, start: int) -> None:
    """Write the block ``src`` (all rows and heads, its positions along
    ``dim`` from ``start``, clamped as :func:`clamped_block_index` clamps)
    into the slots of it that ``dst`` holds."""
    s = src.shape[dim]
    block0 = min(max(start, 0), max(placed.length - s, 0))
    held = dst.shape[dim]
    a, b = max(block0, placed.slot0), min(block0 + s, placed.slot0 + held)
    if a < b:
        dst.narrow(dim, a - placed.slot0, b - a).copy_(src.narrow(dim, a - block0, b - a))


def _partial_softmax(scores: torch.Tensor, weighted):
    """(max, sum, weighted values) of a softmax over the last dim of
    ``scores`` (masked entries already biased): ``weighted(p)`` gives the
    values weighted by the unnormalised probabilities ``p``. No keys give
    max -inf, sum 0 and zero values."""
    if scores.shape[-1] == 0:
        m = torch.full(scores.shape[:-1], float("-inf"), device=scores.device)
        p = torch.zeros_like(scores)
        return m, p.sum(-1), weighted(p)
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    return m, p.sum(-1), weighted(p)


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


def _scores(qg, k, q_pos, k_pos, *, scale, attn_softcap, causal, window, prefix_len,
            valid):
    """Masked f32 scores [b, hkv, g, s, t] of qg [b, hkv, g, s, d] against
    k [b, hkv, t, d]; ``valid`` [t] masks cache slots not yet written."""
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    scores = softcap(scores, attn_softcap)
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=window,
                      prefix_len=prefix_len)
    if valid is not None:
        bias = bias + torch.where(valid, 0.0, -1e30)[None, :]
    return scores + bias


def _scores_attention(qg, k, v, q_pos, k_pos, **masks):
    """Direct softmax attention in f32 over :func:`_scores`."""
    probs = torch.softmax(_scores(qg, k, q_pos, k_pos, **masks), dim=-1)
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
    cache: KVCache | PlacedCache | None = None,  # append & attend over cache
    cross_kv: tuple | None = None,  # encoder K/V for cross-attention
    start: int | None = None,      # positions[0] as a Python int, if known
    tp=None,                       # a placed cache's rows and heads
) -> tuple[torch.Tensor, KVCache | PlacedCache | None]:
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

    new_cache = placed = None
    if cache is not None and cross_kv is None:
        new_cache = cache
        if isinstance(cache, PlacedCache):
            placed, cache = cache, cache.cache
            if start is None:
                start = int(positions[0])
            for dst, src in ((cache.k, k), (cache.v, v)):
                _write_placed(placed, dst, tp.gather_rows_heads(src), 2, start)
        else:
            # write k/v at the pass's positions (the block's start clamped)
            idx = clamped_block_index(positions, cache.k.shape[2])
            cache.k.index_copy_(2, idx, k)
            cache.v.index_copy_(2, idx, v)
        # the kernel attends over the pass's own k/v: a prefill from
        # position 0 sees nothing else of the cache, a later one does
        prefill = prefill and (int(positions[0]) if start is None else start) == 0

    if placed is not None and placed.split and not prefill:
        out = _gqa_spread(q, cache, placed, positions, cfg, tp, scale=scale,
                          causal=causal, window=window, prefix_len=prefix_len)
    elif prefill:
        out = flash_attention_padded(
            q, k, v, sm_scale=scale,
            window=window if window is not None and window > 0 else None,
            softcap=cfg.attn_softcap,
        )
    else:
        if new_cache is not None:
            # decode, or a prefill at an offset: attend over the whole
            # cache (this rank's rows and heads of it), unwritten slots masked
            k, v = cache.k, cache.v
            if placed is not None:
                k, v = tp.local_rows_heads(k), tp.local_rows_heads(v)
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


def _gqa_spread(q, cache: KVCache, placed: PlacedCache, positions, cfg, tp, *,
                scale, causal, window, prefix_len) -> torch.Tensor:
    """Attention of this rank's rows and heads ``q`` over a cache spread
    over ranks: every row's and head's partial softmax over the slots this
    rank holds, combined over ``placed.split``."""
    from ..sharding.spmd import combine_softmax

    q_all = tp.gather_rows_heads(q)                          # [B, Hq, s, D]
    bsz, hq, s, hd = q_all.shape
    hkv = cache.k.shape[1]
    k_pos = placed.slot0 + torch.arange(cache.k.shape[2], device=q.device)
    scores = _scores(q_all.reshape(bsz, hkv, hq // hkv, s, hd), cache.k, positions, k_pos,
                     scale=scale, attn_softcap=cfg.attn_softcap, causal=causal,
                     window=window, prefix_len=prefix_len, valid=k_pos <= positions[-1])
    m, l, o = _partial_softmax(scores, lambda p: torch.einsum(
        "bhgqk,bhkd->bhgqd", p, cache.v.float()))
    out = combine_softmax(m, l, o, tp.spmd, placed.split)
    return tp.local_rows_heads(out.reshape(bsz, hq, s, hd))


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
    cache: MLACache | PlacedCache | None = None,  # append & attend over cache
    start: int | None = None,       # positions[0] as a Python int, if known
    tp=None,                        # a placed cache's rows
) -> tuple[torch.Tensor, MLACache | PlacedCache | None]:
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

    new_cache = placed = None
    k_pos, valid = positions, None
    if isinstance(cache, PlacedCache):
        placed, new_cache = cache, cache
        if start is None:
            start = int(positions[0])
        packed = tp.gather_rows_heads(torch.cat([c_kv, k_rope], dim=-1), heads=False)
        _write_placed(placed, cache.cache.c_kv, packed, 1, start)
        if not placed.split:
            full = tp.local_rows_heads(cache.cache.c_kv, heads=False)
            c_kv, k_rope = full[..., :m.kv_lora], full[..., m.kv_lora:]
            k_pos = torch.arange(placed.length, device=x.device)
            valid = k_pos <= positions[-1]
        elif s == 1 or start != 0:
            out = _mla_spread(params, q_nope, q_rope, cache.cache, placed,
                              positions, cfg, tp)
            return out.to(x.dtype) @ params["w_o"], new_cache
        # else a prefill from 0 over a spread cache: its own latents
    elif cache is not None:
        cache.c_kv.index_copy_(1, clamped_block_index(positions, cache.c_kv.shape[1]),
                               torch.cat([c_kv, k_rope], dim=-1))
        new_cache = cache
        c_kv, k_rope = cache.c_kv[..., :m.kv_lora], cache.c_kv[..., m.kv_lora:]
        k_pos = torch.arange(cache.c_kv.shape[1], device=x.device)
        valid = k_pos <= positions[-1]

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
        probs = torch.softmax(_mla_scores(q_nope, q_rope, k_nope, k_rope, scale,
                                          positions, k_pos, valid), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    out = out.reshape(b, s, h * m.v_dim).to(x.dtype)
    return out @ params["w_o"], new_cache


def _mla_scores(q_nope, q_rope, k_nope, k_rope, scale, positions, k_pos, valid):
    """MLA's masked f32 scores [b, h, s, t]: the reference's (nope + rope)
    * scale + bias, in place (at a 2048-token prefill of V3 each [b, h, s,
    t] f32 term is 8.7 GB)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
    scores.add_(torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float()))
    scores.mul_(scale)
    bias = _mask_bias(positions, k_pos, causal=True, window=None)
    if valid is not None:
        bias = bias + torch.where(valid, 0.0, -1e30)[None, :]
    return scores.add_(bias)


def _mla_spread(params, q_nope, q_rope, cache: MLACache, placed: PlacedCache,
                positions, cfg, tp) -> torch.Tensor:
    """MLA of this rank's rows over a cache spread over ranks (as
    :func:`_gqa_spread`); returns [b, s, h * v_dim] in f32."""
    from ..sharding.spmd import combine_softmax

    m = cfg.mla
    q_nope = tp.gather_rows_heads(q_nope, heads=False)       # [B, s, h, dn]
    q_rope = tp.gather_rows_heads(q_rope, heads=False)
    bsz, s, h, _ = q_nope.shape
    t = cache.c_kv.shape[1]
    c_kv = rms_norm(cache.c_kv[..., :m.kv_lora], params["kv_norm"])
    k_rope = cache.c_kv[..., m.kv_lora:]
    k_nope = (c_kv @ params["w_uk"]).reshape(bsz, t, h, m.qk_nope_dim)
    v = (c_kv @ params["w_uv"]).reshape(bsz, t, h, m.v_dim)
    k_pos = placed.slot0 + torch.arange(t, device=q_nope.device)
    scores = _mla_scores(q_nope, q_rope, k_nope, k_rope, (m.qk_nope_dim + m.rope_dim) ** -0.5,
                         positions, k_pos, k_pos <= positions[-1])
    mx, l, o = _partial_softmax(scores, lambda p: torch.einsum(
        "bhqk,bkhd->bhqd", p, v.float()))
    out = combine_softmax(mx, l, o, tp.spmd, placed.split)   # [B, h, s, dv]
    out = tp.local_rows_heads(out.transpose(1, 2), heads=False)
    return out.reshape(out.shape[0], s, h * m.v_dim)


def make_mla_cache(cfg, batch: int, cache_len: int, dtype, device) -> MLACache:
    m = cfg.mla
    return MLACache(torch.zeros((batch, cache_len, m.kv_lora + m.rope_dim),
                                dtype=dtype, device=device))
