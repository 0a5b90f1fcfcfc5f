"""xLSTM LM (arXiv:2405.04517): alternating mLSTM / sLSTM blocks.

The PyTorch counterpart of the JAX package's ``src/repro/models/xlstm.py``.
xlstm-125m: 12 layers, d_model 768, 4 heads, no separate FFN blocks (mixing
blocks only), vocab 50304. Even layers are mLSTM, odd layers sLSTM. mLSTM
runs chunk-parallel; sLSTM is a sequential loop over time (its recurrence
is not parallelisable). Decode carries O(1) recurrent state per layer.

With ``cfg.remat``, grad mode on and a parallel pass without states (a
training pass), each mixer runs under ``torch.utils.checkpoint`` (the
reference wraps it in ``jax.checkpoint``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import resolve_device
from .api import ArchConfig
from .layers import cross_entropy_loss, dense_param, embed_param, generator, rms_norm
from .ssm import (
    MLSTMState, mlstm, mlstm_init, mlstm_step, slstm, slstm_init, slstm_step,
    slstm_zero_state,
)


def xlstm_init(seed: int, cfg: ArchConfig, device="cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the reference's init distributions; torch's numbers, not JAX's)."""
    device = resolve_device(device)
    gen = generator(seed, device)
    d, dtype = cfg.d_model, cfg.dtype
    params: dict = {
        "embed": embed_param(gen, cfg.vocab, d, dtype, device),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
        "lm_head": dense_param(gen, d, cfg.vocab, dtype, device),
    }
    layers = []
    for i in range(cfg.num_layers):
        if i % 2 == 0:
            mixer = {"kind_mlstm": mlstm_init(gen, d, cfg.num_heads, dtype, device)}
        else:
            mixer = {"kind_slstm": slstm_init(gen, d, cfg.num_heads, dtype, device)}
        layers.append({**mixer, "norm": torch.zeros((d,), dtype=dtype, device=device)})
    params["layers"] = layers
    return params


def _forward(params, cfg: ArchConfig, tokens, states=None):
    x = params["embed"][tokens]
    chunk = cfg.ssm.chunk if cfg.ssm else 128
    train_mode = tokens.shape[1] > 1 and states is None
    remat = cfg.remat and train_mode and torch.is_grad_enabled()
    new_states = []

    def mlstm_layer(p, h):
        return mlstm(p, h, cfg.num_heads, chunk=chunk)

    def slstm_layer(p, h):
        return slstm(p, h, cfg.num_heads)

    for i, lp in enumerate(params["layers"]):
        h = rms_norm(x, lp["norm"])
        st = states[i] if states is not None else None
        if "kind_mlstm" in lp:
            p = lp["kind_mlstm"]
            if tokens.shape[1] == 1 and st is not None:
                out, ns = mlstm_step(p, h, st, cfg.num_heads)
            elif remat:
                out, ns = checkpoint(mlstm_layer, p, h, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                out, ns = mlstm_layer(p, h)
        else:
            p = lp["kind_slstm"]
            if tokens.shape[1] == 1 and st is not None:
                out, ns = slstm_step(p, h, st, cfg.num_heads)
            elif remat:
                out, ns = checkpoint(slstm_layer, p, h, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                out, ns = slstm(p, h, cfg.num_heads, state=st)
        x = x + out
        new_states.append(ns)
    return x, new_states


def _unembed(params, x):
    return rms_norm(x, params["final_norm"]) @ params["lm_head"]


def xlstm_loss(params, cfg: ArchConfig, batch):
    x, _ = _forward(params, cfg, batch["tokens"])
    loss = cross_entropy_loss(_unembed(params, x), batch["labels"])
    return loss, {"ce": loss}


def xlstm_make_states(params, cfg: ArchConfig, batch: int):
    device = params["embed"].device
    dh = cfg.d_model // cfg.num_heads
    states = []
    for i in range(cfg.num_layers):
        if i % 2 == 0:
            states.append(MLSTMState(torch.zeros((batch, cfg.num_heads, dh, dh + 1),
                                                 dtype=torch.float32, device=device)))
        else:
            states.append(slstm_zero_state(batch, cfg.d_model, cfg.num_heads, device))
    return states


def xlstm_decode_step(params, cfg: ArchConfig, token, states, pos=None):
    """One decode step from each layer's state; ``pos`` is not used (the
    state carries the position)."""
    x, new_states = _forward(params, cfg, token, states)
    return _unembed(params, x)[:, -1], new_states


def xlstm_prefill(params, cfg: ArchConfig, tokens):
    """The parallel pass over ``tokens``; returns the last position's
    logits and each layer's final state. Only the last position is
    unembedded (the reference unembeds all and keeps the last; the rows are
    independent)."""
    x, states = _forward(params, cfg, tokens)
    return _unembed(params, x[:, -1:])[:, -1], states
