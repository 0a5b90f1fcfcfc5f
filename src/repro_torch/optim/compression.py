"""Gradient compression with error feedback (distributed-optimization trick).

The PyTorch counterpart of the JAX package's
``src/repro/optim/compression.py``: int8 block quantisation of gradients
before the data-parallel reduction, with an error-feedback residual so that
compression noise is unbiased over steps (Seide et al. / EF-SGD family).
``torch.round`` rounds half to even, as ``jnp.round`` does, so payloads and
scales equal the reference's.

:func:`compressed_psum_mean` is the reduction over a slow (cross-pod) mesh
axis with an int8 wire: each rank quantises locally, all-gathers the int8
payload and the f32 block scales over the axis's process group, and
dequantises and averages locally.
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
    """Error-feedback compression: g' = Q(g + r); r' = (g + r) - g'.

    The per-layer leaves of a ``*_stack`` are quantised together, in layer
    order, as the one ``[L, ...]`` leaf the reference holds: its 256-blocks
    run across layers wherever a layer's leaf is not a multiple of 256."""
    from ..sharding.rules import stacked_view

    flat_g, flat_r = leaves(grads), leaves(residual)
    groups: dict = {}
    for i, (_, ref) in enumerate(stacked_view(grads)[1]):
        groups.setdefault(ref, []).append(i)
    out_g, out_r = list(flat_g), list(flat_r)
    for idx in groups.values():
        target = torch.cat([(flat_g[i].float() + flat_r[i]).reshape(-1) for i in idx])
        q, s = compress(target)
        deq = decompress(q, s, tuple(target.shape))
        sizes = [flat_g[i].numel() for i in idx]
        for i, d, r in zip(idx, deq.split(sizes), (target - deq).split(sizes)):
            out_g[i] = d.view(flat_g[i].shape).to(flat_g[i].dtype)
            out_r[i] = r.view(flat_g[i].shape)
    return unflatten(grads, out_g), unflatten(grads, out_r)


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum_mean(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``axis`` (a name or a tuple of names
    of ``mesh``, a ``DeviceMesh``) with an int8 wire: the payloads and the
    f32 scales are what the all-gather carries (1/4 of f32's bytes, plus a
    scale per 256 values); the result has ``x``'s dtype, the same on every
    rank of the axis."""
    from ..sharding.spmd import Spmd, all_gather

    spmd = Spmd(mesh)
    q, scale = compress(x)
    qs = all_gather(q[None], spmd, axis, 0)            # int8 across the axis
    ss = all_gather(scale[None], spmd, axis, 0)
    deq = torch.stack([decompress(qq, sc, tuple(x.shape)) for qq, sc in zip(qs, ss)])
    return deq.mean(dim=0).to(x.dtype)
