"""Common neural layers for the model zoo (functional, dict-of-tensors params).

The PyTorch counterpart of the JAX package's ``src/repro/models/layers.py``.
Parameter keys and layouts are the reference's (``w_*`` weights are
``[in, out]``), so a reference parameter tree carries across as it is
(``interop.lm_params_from_numpy``). Compute runs in the config dtype (bf16
by default) with f32 for norms, rotary angles and softcaps, each cast back to
the input dtype where the reference casts.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` seeded with ``seed`` for draws on ``device``.
    A ``meta`` device draws nothing (its tensors hold shapes only), so it
    takes a CPU generator, which ``torch.randn(..., device="meta")``
    accepts."""
    device = torch.device(device)
    return torch.Generator(device="cpu" if device.type == "meta" else device).manual_seed(seed)


def dense_param(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
                device) -> torch.Tensor:
    """N(0, 1/in_dim) weight ``[in_dim, out_dim]``, drawn in f32."""
    w = torch.randn((in_dim, out_dim), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_param(gen: torch.Generator, vocab: int, dim: int, dtype,
                device) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with the ``1 + weight`` scale (weights start at 0)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in f32 (the biased variance), cast back."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding (halves layout). x: [..., seq, dim(even)],
    positions: [..., seq] (broadcast against x's leading dims)."""
    dim = x.shape[-1]
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., :, None].float() * freqs          # [..., seq, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                    device) -> dict:
    return {
        "w_gate": dense_param(gen, d_model, d_ff, dtype, device),
        "w_up": dense_param(gen, d_model, d_ff, dtype, device),
        "w_down": dense_param(gen, d_ff, d_model, dtype, device),
    }


def swiglu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ params["w_gate"])
    return (gate * (x @ params["w_up"])) @ params["w_down"]


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                  device) -> dict:
    return {
        "w_up": dense_param(gen, d_model, d_ff, dtype, device),
        "w_down": dense_param(gen, d_ff, d_model, dtype, device),
    }


def gelu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ params["w_up"], approximate="tanh") @ params["w_down"]


def geglu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Gemma-style GeGLU (same param layout as swiglu)."""
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")
    return (gate * (x @ params["w_up"])) @ params["w_down"]


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """``cap * tanh(x / cap)`` in f32, cast back; identity when cap is None."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token CE in f32, with an optional z-loss stabiliser."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * (lse**2).mean()
    return loss
