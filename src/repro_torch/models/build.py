"""Decoder-LM assembly for the dense family.

The PyTorch counterpart of the dense part of the JAX package's
``src/repro/models/build.py``. Parameters are nested dicts of tensors with
the reference's keys; a layer stack is a list of per-layer dicts (the
reference stacks them on a leading axis for ``lax.scan``), run by a plain
loop. With ``cfg.remat``, grad mode on and no caches, each layer runs under
``torch.utils.checkpoint`` (the reference wraps each layer in
``jax.checkpoint``): its activations are recomputed in the backward. Caches
are lists of per-layer :class:`KVCache`, updated in place. ``lm_loss`` is
the training loss.

Not ported yet, and raising ``NotImplementedError`` when a config asks for
them: MoE stacks, multi-token prediction (``mtp``), meta tokens,
prefix-LM masking and frontends (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import resolve_device
from .api import ArchConfig
from .attention import (
    NOT_PORTED, KVCache, gqa_attention, gqa_init, make_kv_cache,
)
from .layers import (
    cross_entropy_loss, dense_param, embed_param, geglu_mlp, gelu_mlp,
    gelu_mlp_init, rms_norm, softcap, swiglu_mlp, swiglu_mlp_init,
)

def check_ported(cfg: ArchConfig) -> None:
    """Raise for a config that needs a part of the LM path not ported yet."""
    missing = [name for name, on in (
        ("MoE layers", cfg.moe is not None),
        ("MLA attention", cfg.mla is not None),
        ("multi-token prediction", cfg.mtp),
        ("meta tokens", bool(cfg.num_meta_tokens)),
        ("prefix-LM masking", cfg.prefix_lm),
        ("a frontend", cfg.frontend is not None),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet: {NOT_PORTED}")


# ------------------------------------------------------------------ blocks

def block_init(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    d, dtype = cfg.d_model, cfg.dtype
    p: dict = {"attn_norm": torch.zeros((d,), dtype=dtype, device=device)}
    p["attn"] = gqa_init(gen, cfg, dtype, device)
    p["ffn_norm"] = torch.zeros((d,), dtype=dtype, device=device)
    if cfg.mlp_kind == "gelu":
        p["mlp"] = gelu_mlp_init(gen, d, cfg.d_ff, dtype, device)
    else:
        p["mlp"] = swiglu_mlp_init(gen, d, cfg.d_ff, dtype, device)
    if cfg.sandwich_norm:
        p["post_attn_norm"] = torch.zeros((d,), dtype=dtype, device=device)
        p["post_ffn_norm"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def block_apply(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, *, window: int | None = None,
                cache: KVCache | None = None):
    """One pre-norm block; returns (x, cache)."""
    h = rms_norm(x, p["attn_norm"])
    a, new_cache = gqa_attention(p["attn"], h, positions, cfg, window=window,
                                 cache=cache)
    if cfg.sandwich_norm:
        a = rms_norm(a, p["post_attn_norm"])
    x = x + a

    h = rms_norm(x, p["ffn_norm"])
    if cfg.mlp_kind == "gelu":
        f = gelu_mlp(p["mlp"], h)
    elif cfg.mlp_kind == "geglu":
        f = geglu_mlp(p["mlp"], h)
    else:
        f = swiglu_mlp(p["mlp"], h)
    if cfg.sandwich_norm:
        f = rms_norm(f, p["post_ffn_norm"])
    return x + f, new_cache


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
               cfg: ArchConfig, window: int) -> torch.Tensor:
    """A block without a cache, as :func:`apply_stack` checkpoints it."""
    return block_apply(p, x, positions, cfg, window=window)[0]


def apply_stack(stack: list[dict], windows: np.ndarray, x: torch.Tensor,
                positions: torch.Tensor, cfg: ArchConfig, *, caches=None):
    """A plain loop over the layers of one stack; returns (x, caches).

    With ``cfg.remat``, grad mode on and no caches, each layer is a
    non-reentrant ``torch.utils.checkpoint``: the backward runs its forward
    again (the flash kernel included) and uses only that recompute's saved
    tensors."""
    if cfg.remat and caches is None and torch.is_grad_enabled():
        for i, p_l in enumerate(stack):
            x = checkpoint(_block_out, p_l, x, positions, cfg, int(windows[i]),
                           use_reentrant=False, preserve_rng_state=False)
        return x, None
    new_caches = []
    for i, p_l in enumerate(stack):
        x, nc = block_apply(p_l, x, positions, cfg, window=int(windows[i]),
                            cache=None if caches is None else caches[i])
        new_caches.append(nc)
    return x, (new_caches if caches is not None else None)


# ----------------------------------------------------------- decoder LM

def _lm_init(seed: int, cfg: ArchConfig, device="cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the reference's init distributions; torch's numbers, not JAX's)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: dict = {
        "embed": embed_param(gen, cfg.vocab, cfg.d_model, cfg.dtype, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_param(gen, cfg.d_model, cfg.vocab, cfg.dtype, device)
    params["dense_stack"] = [block_init(gen, cfg, device)
                             for _ in range(cfg.num_layers)]
    return params


def _stacks(cfg: ArchConfig):
    """(params key, layers, window offset) of each layer stack."""
    check_ported(cfg)
    return [("dense_stack", cfg.num_layers, 0)]


def _embed(params, cfg, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = (x.float() * cfg.d_model**0.5).to(x.dtype)
    return x


def _unembed(params, cfg, x):
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(x @ head, cfg.final_softcap)


def lm_forward(params, cfg: ArchConfig, tokens, *, caches=None, positions=None):
    """Shared trunk: embeddings -> stacks -> hidden states (+ caches)."""
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    new_caches: dict = {}
    for stack_name, n_layers, offset in _stacks(cfg):
        x, nc = apply_stack(
            params[stack_name], layer_windows(cfg, n_layers, offset), x,
            positions, cfg,
            caches=caches.get(stack_name) if caches is not None else None,
        )
        new_caches[stack_name] = nc
    return x, (new_caches if caches is not None else None)


def lm_loss(params, cfg: ArchConfig, batch):
    """Mean next-token cross-entropy (with the reference's z-loss) of
    ``batch["tokens"]`` against ``batch["labels"]``; returns (loss, metrics)
    with metrics ``ce`` and ``aux`` (0 for the dense family: no MoE)."""
    x, _ = lm_forward(params, cfg, batch["tokens"])
    logits = _unembed(params, cfg, x)
    loss = cross_entropy_loss(logits, batch["labels"])
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    metrics = {"ce": loss, "aux": aux}
    return loss + aux, metrics


# ----------------------------------------------------------- serve paths

def lm_make_caches(params, cfg: ArchConfig, batch: int, cache_len: int):
    device = params["embed"].device
    return {name: [make_kv_cache(cfg, batch, cache_len, cfg.dtype, device)
                   for _ in range(n_layers)]
            for name, n_layers, _ in _stacks(cfg)}


def lm_decode_step(params, cfg: ArchConfig, token, caches, pos: int):
    """One decode step: token [B, 1] + caches at absolute position ``pos``."""
    positions = torch.tensor([pos], device=token.device)
    x, new_caches = lm_forward(params, cfg, token, caches=caches,
                               positions=positions)
    return _unembed(params, cfg, x)[:, -1], new_caches


def lm_prefill(params, cfg: ArchConfig, tokens, cache_len: int):
    """Parallel prefill that also fills decode caches: the prompt's k/v are
    written at cache offset 0, and attention runs in the flash kernel.
    Only the last position is unembedded (the reference unembeds all and
    keeps the last; the rows are independent, so the logits are the same)."""
    caches = lm_make_caches(params, cfg, tokens.shape[0], cache_len)
    x, new_caches = lm_forward(params, cfg, tokens, caches=caches)
    return _unembed(params, cfg, x[:, -1:])[:, -1], new_caches
