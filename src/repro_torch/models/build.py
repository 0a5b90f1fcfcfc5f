"""Decoder-LM assembly for the dense, MoE and vision-language families.

The PyTorch counterpart of the JAX package's ``src/repro/models/build.py``.
Parameters are nested dicts of tensors with the reference's keys; a layer
stack is a list of per-layer dicts (the reference stacks them on a leading
axis for ``lax.scan``), run by a plain loop. An MoE model has a stack of
``num_dense_layers`` dense blocks and one of MoE blocks after it; MLA
replaces GQA in every block when ``cfg.mla`` is set, and ``cfg.mtp`` adds
the multi-token-prediction head to the loss. ``cfg.num_meta_tokens``
learned rows, and a vlm's ``prefix_embeds`` (the stubbed vision tower's
patch embeddings), are prepended on passes of more than one token; with
``cfg.prefix_lm`` attention is bidirectional over that prefix. With
``cfg.remat``, grad mode on and no caches, each layer runs under
``torch.utils.checkpoint`` (the reference wraps each layer in
``jax.checkpoint``): its activations, and its MoE aux loss, are recomputed
in the backward. Caches are lists of per-layer
:class:`KVCache` or :class:`MLACache`, updated in place. ``lm_loss`` is the
training loss.

Given a mesh, ``build_model`` runs the same loss on each rank's shards:
``lm_loss``'s ``tp`` (``models/sharded.py``'s ``TensorParallel``; None on
one device) takes the placed weights to local ones, sums the row-parallel
partial outputs over the model axis, looks the embedding up and takes the
cross-entropy over a vocab sharded on that axis, and runs the reference's
expert-parallel ``shard_map`` island for the MoE FFN. ``lm_prefill`` and
``lm_decode_step`` take ``tp`` too: the whole batch in, the whole logits
out, each rank on its rows and heads over its part of the placed caches
(``models/sharded.py`` says how).

A pass's first position travels as a Python int (``start``) where it is
known, so no step reads a position back from the device: the model runs
on ``meta`` tensors too (``launch/dryrun.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import resolve_device
from .api import ArchConfig
from .attention import (
    KVCache, MLACache, PlacedCache, gqa_attention, gqa_init, make_kv_cache,
    make_mla_cache, mla_attention, mla_init,
)
from .layers import (
    cross_entropy_loss, dense_param, embed_param, geglu_mlp, gelu_mlp,
    gelu_mlp_init, generator, rms_norm, softcap, swiglu_mlp, swiglu_mlp_init,
)
from .moe import moe_ffn, moe_init


# ------------------------------------------------------------------ blocks

def block_init(gen: torch.Generator, cfg: ArchConfig, kind: str, device) -> dict:
    d, dtype = cfg.d_model, cfg.dtype
    p: dict = {"attn_norm": torch.zeros((d,), dtype=dtype, device=device)}
    if cfg.mla is not None:
        p["attn"] = mla_init(gen, cfg, dtype, device)
    else:
        p["attn"] = gqa_init(gen, cfg, dtype, device)
    p["ffn_norm"] = torch.zeros((d,), dtype=dtype, device=device)
    if kind == "moe":
        p["moe"] = moe_init(gen, cfg, dtype, device)
    elif cfg.mlp_kind == "gelu":
        p["mlp"] = gelu_mlp_init(gen, d, cfg.d_ff, dtype, device)
    else:
        p["mlp"] = swiglu_mlp_init(gen, d, cfg.d_ff, dtype, device)
    if cfg.sandwich_norm:
        p["post_attn_norm"] = torch.zeros((d,), dtype=dtype, device=device)
        p["post_ffn_norm"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def block_apply(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, *, kind: str, window: int | None = None,
                prefix_len: int | None = None,
                cache: KVCache | MLACache | PlacedCache | None = None, tp=None,
                start: int | None = None):
    """One pre-norm block; returns (x, cache, aux), aux the MoE block's
    load-balance loss (0 for a dense block). With ``tp``, ``p`` holds this
    rank's placed shards. ``start`` is the pass's first position, if the
    caller knows it."""
    attn_cfg = cfg
    if tp is not None:
        p, attn_cfg = tp.block(p), tp.attn_cfg
    h = rms_norm(x, p["attn_norm"])
    if cfg.mla is not None:
        a, new_cache = mla_attention(p["attn"], h, positions, cfg, cache=cache,
                                     start=start, tp=tp)
    else:
        a, new_cache = gqa_attention(p["attn"], h, positions, attn_cfg,
                                     window=window, cache=cache,
                                     prefix_len=prefix_len, start=start, tp=tp)
    if tp is not None:
        a = tp.reduce_attn(a)
    if cfg.sandwich_norm:
        a = rms_norm(a, p["post_attn_norm"])
    x = x + a

    h = rms_norm(x, p["ffn_norm"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "moe":
        f, aux = (moe_ffn if tp is None else tp.moe)(p["moe"], h, cfg)
    else:
        if cfg.mlp_kind == "gelu":
            f = gelu_mlp(p["mlp"], h)
        elif cfg.mlp_kind == "geglu":
            f = geglu_mlp(p["mlp"], h)
        else:
            f = swiglu_mlp(p["mlp"], h)
        if tp is not None:
            f = tp.reduce_mlp(f)
    if cfg.sandwich_norm:
        f = rms_norm(f, p["post_ffn_norm"])
    return x + f, new_cache, aux


# ------------------------------------------------------------- layer stacks

def layer_windows(cfg: ArchConfig, num_layers: int, offset: int = 0) -> np.ndarray:
    """Per-layer sliding window (0 = global)."""
    w = np.zeros(num_layers, np.int32)
    if cfg.window_pattern == "alternating" and cfg.sliding_window:
        for i in range(num_layers):
            if (i + offset) % 2 == 0:
                w[i] = cfg.sliding_window
    elif cfg.window_pattern == "hymba" and cfg.sliding_window:
        w[:] = cfg.sliding_window
        for g in (0, num_layers // 2, num_layers - 1):
            w[g] = 0
    return w


def _block_out(p: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ArchConfig, kind: str, window: int, prefix_len: int | None, tp):
    """A block without a cache, as :func:`apply_stack` checkpoints it:
    (x, aux), so that the aux loss keeps its gradient through the
    recompute."""
    out, _, aux = block_apply(p, x, positions, cfg, kind=kind, window=window,
                              prefix_len=prefix_len, tp=tp)
    return out, aux


def apply_stack(stack: list[dict], windows: np.ndarray, x: torch.Tensor,
                positions: torch.Tensor, cfg: ArchConfig, *, kind: str,
                caches=None, prefix_len: int | None = None, tp=None,
                start: int | None = None):
    """A plain loop over the layers of one stack; returns (x, aux summed
    over the layers, caches).

    With ``cfg.remat``, grad mode on and no caches, each layer is a
    non-reentrant ``torch.utils.checkpoint``: the backward runs its forward
    again (the flash kernel included) and uses only that recompute's saved
    tensors (with ``tp``, its weights' gathers too)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.remat and caches is None and torch.is_grad_enabled():
        for i, p_l in enumerate(stack):
            x, aux_l = checkpoint(_block_out, p_l, x, positions, cfg, kind,
                                  int(windows[i]), prefix_len, tp, use_reentrant=False,
                                  preserve_rng_state=False)
            aux = aux + aux_l
        return x, aux, None
    new_caches = []
    for i, p_l in enumerate(stack):
        x, nc, aux_l = block_apply(p_l, x, positions, cfg, kind=kind,
                                   window=int(windows[i]), prefix_len=prefix_len,
                                   cache=None if caches is None else caches[i], tp=tp,
                                   start=start)
        aux = aux + aux_l
        new_caches.append(nc)
    return x, aux, (new_caches if caches is not None else None)


# ----------------------------------------------------------- decoder LM

def _lm_init(seed: int, cfg: ArchConfig, device="cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the reference's init distributions; torch's numbers, not JAX's)."""
    device = resolve_device(device)
    gen = generator(seed, device)
    params: dict = {
        "embed": embed_param(gen, cfg.vocab, cfg.d_model, cfg.dtype, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_param(gen, cfg.d_model, cfg.vocab, cfg.dtype, device)
    for stack_name, kind, n_layers, _ in _stacks(cfg):
        params[stack_name] = [block_init(gen, cfg, kind, device)
                              for _ in range(n_layers)]
    if cfg.mtp:
        params["mtp_proj"] = dense_param(gen, 2 * cfg.d_model, cfg.d_model,
                                         cfg.dtype, device)
        params["mtp_block"] = block_init(gen, cfg, "dense", device)
        params["mtp_norm"] = torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                         device=device)
    if cfg.num_meta_tokens:
        meta = torch.randn((cfg.num_meta_tokens, cfg.d_model), generator=gen,
                           device=device, dtype=torch.float32)
        params["meta_tokens"] = (meta * 0.02).to(cfg.dtype)
    return params


def _stacks(cfg: ArchConfig):
    """(params key, block kind, layers, window offset) of each layer stack:
    an MoE model's ``num_dense_layers`` dense blocks, then its MoE blocks."""
    n_dense = cfg.num_dense_layers if cfg.moe else cfg.num_layers
    n_moe = cfg.num_layers - n_dense if cfg.moe else 0
    out = []
    if n_dense:
        out.append(("dense_stack", "dense", n_dense, 0))
    if n_moe:
        out.append(("moe_stack", "moe", n_moe, n_dense))
    return out


def _embed(params, cfg, tokens, tp=None):
    x = params["embed"][tokens] if tp is None else tp.embed(params["embed"], tokens)
    if cfg.embed_scale:
        x = (x.float() * cfg.d_model**0.5).to(x.dtype)
    return x


def _unembed(params, cfg, x):
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(x @ head, cfg.final_softcap)


def lm_forward(params, cfg: ArchConfig, tokens, *, caches=None, positions=None,
               prefix_embeds=None, tp=None, start: int | None = None):
    """Shared trunk: embeddings -> stacks -> (hidden states, aux summed over
    the layers, caches). On a pass of more than one token the meta tokens,
    then ``prefix_embeds`` [b, p, d_model], are prepended (during decode
    they already sit in the cache); with ``cfg.prefix_lm`` attention is
    bidirectional over everything prepended. ``start`` is ``positions[0]``
    as a Python int (0 when ``positions`` is None)."""
    b, s = tokens.shape
    x = _embed(params, cfg, tokens, tp)
    if params.get("meta_tokens") is not None and s > 1:
        meta = params["meta_tokens"][None].expand(b, cfg.num_meta_tokens, cfg.d_model)
        x = torch.cat([meta.to(x.dtype), x], dim=1)
    if prefix_embeds is not None and s > 1:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    s_eff = x.shape[1]
    if positions is None:
        positions, start = torch.arange(s_eff, device=x.device), 0
    prefix_len = (s_eff - s) if (cfg.prefix_lm and s_eff > s) else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: dict = {}
    for stack_name, kind, n_layers, offset in _stacks(cfg):
        x, aux_s, nc = apply_stack(
            params[stack_name], layer_windows(cfg, n_layers, offset), x,
            positions, cfg, kind=kind,
            caches=caches.get(stack_name) if caches is not None else None,
            prefix_len=prefix_len, tp=tp, start=start,
        )
        aux = aux + aux_s
        new_caches[stack_name] = nc
    return x, aux, (new_caches if caches is not None else None)


def lm_loss(params, cfg: ArchConfig, batch, tp=None):
    """Mean next-token cross-entropy (with the reference's z-loss) of
    ``batch["tokens"]`` against ``batch["labels"]``, plus ``mtp_weight``
    times the multi-token-prediction loss (``cfg.mtp``: the token after
    next, from the last hidden state and the next token's embedding) and
    the MoE aux loss; returns (loss, metrics) with metrics ``ce``, ``aux``
    (0 without MoE layers) and, with MTP, ``mtp``. A vlm batch's
    ``prefix_embeds`` go before the tokens; the rows of any prefix are
    dropped before the head. With ``tp``, ``params`` are this rank's placed
    shards and ``batch`` its batch shard; the loss is the mean over this
    rank's tokens, its logits this rank's vocab columns."""
    ce = cross_entropy_loss
    if tp is not None:
        params, ce = tp.top(params), tp.cross_entropy
    tokens, labels = batch["tokens"], batch["labels"]
    x, aux, _ = lm_forward(params, cfg, tokens,
                           prefix_embeds=batch.get("prefix_embeds"), tp=tp)
    strip = x.shape[1] - tokens.shape[1]
    if strip:
        x = x[:, strip:]
    logits = _unembed(params, cfg, x)
    loss = ce(logits, labels)
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp:
        h = x[:, :-1]
        nxt = _embed(params, cfg, tokens[:, 1:], tp)
        m_in = torch.cat([h, nxt], dim=-1) @ params["mtp_proj"]
        m_in = rms_norm(m_in, params["mtp_norm"])
        pos = torch.arange(m_in.shape[1], device=m_in.device)
        m_out = block_apply(params["mtp_block"], m_in, pos, cfg, kind="dense", tp=tp)[0]
        mtp_logits = _unembed(params, cfg, m_out)
        mtp_loss = ce(mtp_logits[:, :-1], labels[:, 2:])
        loss = loss + cfg.mtp_weight * mtp_loss
        metrics["mtp"] = mtp_loss
    return loss + aux, metrics


# ----------------------------------------------------------- serve paths

def lm_make_caches(params, cfg: ArchConfig, batch: int, cache_len: int, tp=None):
    """Zero caches of ``batch`` rows and ``cache_len`` slots, a list per
    stack; with ``tp``, this rank's :class:`PlacedCache` of each layer."""
    device = params["embed"].device
    make = make_mla_cache if cfg.mla is not None else make_kv_cache
    if tp is not None:
        return tp.place_caches({name: [make(cfg, batch, cache_len, cfg.dtype, "meta")] * n
                                for name, _, n, _ in _stacks(cfg)}, device)
    return {name: [make(cfg, batch, cache_len, cfg.dtype, device)
                   for _ in range(n_layers)]
            for name, _, n_layers, _ in _stacks(cfg)}


def _serving(params, tokens, tp):
    """(params, tokens, tp) of a serving pass: with ``tp``, the hooks for
    its batch, the weights outside the layers as this rank uses them and
    this rank's rows."""
    if tp is None:
        return params, tokens, None
    tp = tp.for_batch(tokens.shape[0])
    return tp.top(params), tp.rows(tokens), tp


def lm_decode_step(params, cfg: ArchConfig, token, caches, pos: int, tp=None):
    """One decode step: token [B, 1] + caches at absolute position ``pos``."""
    params, token, tp = _serving(params, token, tp)
    positions = torch.tensor([pos], device=token.device)
    x, _, new_caches = lm_forward(params, cfg, token, caches=caches,
                                  positions=positions, tp=tp, start=pos)
    logits = _unembed(params, cfg, x)[:, -1]
    return (logits if tp is None else tp.whole_logits(logits)), new_caches


def lm_prefill(params, cfg: ArchConfig, tokens, cache_len: int, tp=None):
    """Parallel prefill that also fills decode caches: the prompt's k/v (or
    MLA latents) are written at cache offset 0, and GQA attention runs in
    the flash kernel. Only the last position is unembedded (the reference
    unembeds all and keeps the last; the rows are independent, so the
    logits are the same)."""
    batch = tokens.shape[0]
    params, tokens, tp = _serving(params, tokens, tp)
    caches = lm_make_caches(params, cfg, batch, cache_len, tp)
    x, _, new_caches = lm_forward(params, cfg, tokens, caches=caches, tp=tp)
    logits = _unembed(params, cfg, x[:, -1:])[:, -1]
    return (logits if tp is None else tp.whole_logits(logits)), new_caches
