"""Gradient compression with error feedback (distributed-optimization trick).

The PyTorch counterpart of the JAX package's
``src/repro/optim/compression.py``: int8 block quantisation of gradients
before the data-parallel reduction, with an error-feedback residual so that
compression noise is unbiased over steps (Seide et al. / EF-SGD family).
``torch.round`` rounds half to even, as ``jnp.round`` does, so payloads and
scales equal the reference's.

``compressed_psum_mean`` (the int8 all-gather over a slow mesh axis) waits
for the sharding slice (ROADMAP queue 1, "Sharding and the distributed
substrate").
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..tree import leaves, tree_map, unflatten

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 payload, f32 per-block scales). Blockwise symmetric quant."""
    flat, _ = _pad_to_block(x.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def decompress(q: torch.Tensor, scale: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    n = math.prod(shape)
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:n].reshape(shape)


@torch.no_grad()
def compress_grads_with_feedback(grads: Any, residual: Any) -> tuple[Any, Any]:
    """Error-feedback compression: g' = Q(g + r); r' = (g + r) - g'."""

    def one(g, r):
        target = g.float() + r
        q, s = compress(target)
        deq = decompress(q, s, tuple(g.shape))
        return deq.to(g.dtype), target - deq

    outs = [one(g, r) for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
