"""AdamW with global-norm clipping, self-contained (no torch.optim).

The PyTorch counterpart of the JAX package's ``src/repro/optim/adamw.py``.
All math runs in f32 tensors, as the reference's does, so that ``b1 ** step``
and the cosine schedule round as JAX's f32 ops do (Python floats would
compute them in float64). The update is functional: it returns new
parameters and moments and leaves its inputs as they are.

The reference's ZeRO-1 moment sharding (``moment_shardings``,
``build_opt_shardings``) waits for the sharding slice (ROADMAP queue 1,
"Sharding and the distributed substrate").
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..tree import leaves, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (an f32 tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(1.0, cfg.warmup_steps), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps),
        0.0, 1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments like ``params`` (on each leaf's device) and step 0."""
    flat = leaves(params)
    zeros = [torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
             for p in flat]
    device = flat[0].device if flat else None
    return {
        "m": unflatten(params, zeros),
        "v": unflatten(params, [torch.zeros_like(z) for z in zeros]),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


@torch.no_grad()
def adamw_update(
    grads: Any, opt_state: dict, params: Any, cfg: AdamWConfig
) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_opt_state, metrics). All math in f32."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    def upd(g, m, v, p):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mh = m32 / b1c
        vh = v32 / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        new_p = p.float() - lr * delta
        return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    new = [upd(g, m, v, p) for g, m, v, p in zip(
        leaves(grads), leaves(opt_state["m"]), leaves(opt_state["v"]), leaves(params))]
    new_params = unflatten(params, [t[0] for t in new])
    new_m = unflatten(params, [t[1] for t in new])
    new_v = unflatten(params, [t[2] for t in new])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, {"m": new_m, "v": new_v, "step": step}, metrics
