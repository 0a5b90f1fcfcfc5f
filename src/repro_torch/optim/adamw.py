"""AdamW with global-norm clipping, self-contained (no torch.optim).

The PyTorch counterpart of the JAX package's ``src/repro/optim/adamw.py``.
All math runs in f32 tensors, as the reference's does, so that ``b1 ** step``
and the cosine schedule round as JAX's f32 ops do (Python floats would
compute them in float64). The update is functional: it returns new
parameters and moments and leaves its inputs as they are.

ZeRO-1 (the reference's ``moment_shardings`` and
``build_opt_shardings``): Adam moments follow the param TP sharding *plus*
the largest still-unsharded dim over the 'data' axis when divisible, so the
optimizer state scales down with the full mesh while params keep their TP
layout. :func:`adamw_update_sharded` runs the update on placed state: each
rank updates its moment shard and the matching slice of its parameter
shard, then gathers the parameter back to its own layout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..sharding.rules import NamedSharding, P, axis_sizes, spec_axes, stacked_view
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

    new = [_leaf_update(cfg, g, m, v, p, scale, lr, b1c, b2c) for g, m, v, p in zip(
        leaves(grads), leaves(opt_state["m"]), leaves(opt_state["v"]), leaves(params))]
    new_params = unflatten(params, [t[0] for t in new])
    new_m = unflatten(params, [t[1] for t in new])
    new_v = unflatten(params, [t[2] for t in new])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, {"m": new_m, "v": new_v, "step": step}, metrics


def _leaf_update(cfg: AdamWConfig, g, m, v, p, scale, lr, b1c, b2c):
    """One leaf's AdamW step in f32: (new p, new m, new v) in their dtypes."""
    g = g.float() * scale
    m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
    v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
    mh = m32 / b1c
    vh = v32 / b2c
    delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
    new_p = p.float() - lr * delta
    return new_p.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


# ------------------------------------------------------------------ ZeRO-1

def moment_shardings(param_shardings: Any, mesh, *, data_axis: str = "data"):
    """ZeRO-1 moment shardings: param spec + 'data' on the largest free dim.

    As the reference's, returns ``zero1(sharding, leaf)``, which rewrites one
    param's spec for a leaf of that shape."""
    dsize = axis_sizes(mesh)[data_axis]

    def zero1(sh: NamedSharding, leaf) -> NamedSharding:
        shape = tuple(leaf.shape)
        spec = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
        used = {a for s in spec for a in spec_axes(s)}
        if data_axis in used:  # FSDP params already consume the data axis
            return NamedSharding(mesh, P(*spec))
        best, best_size = -1, 0
        for i, (ax, dim) in enumerate(zip(spec, shape)):
            if ax is None and dim % dsize == 0 and dim > best_size and dim >= dsize:
                best, best_size = i, dim
        if best >= 0:
            spec[best] = data_axis
        return NamedSharding(mesh, P(*spec))

    return zero1


def build_opt_shardings(params_shape: Any, p_shardings: Any, mesh, *,
                        data_axis: str = "data") -> dict:
    """Shardings of ``adamw_init``'s state. The free dim is chosen on the
    reference's stacked shape of a ``*_stack`` leaf (``sharding.rules``),
    and a per-layer leaf gets that spec less the stack entry."""
    zero1 = moment_shardings(p_shardings, mesh, data_axis=data_axis)
    view, order = stacked_view(params_shape)

    def mom(path_ref, sh):
        path, ref = path_ref
        shape, _, stacked = view[ref]
        if not stacked:
            return zero1(sh, _Shape(shape))
        spec = zero1(NamedSharding(mesh, P(None, *sh.spec)), _Shape(shape)).spec
        if spec[0] is not None:
            raise ValueError(f"{path}: ZeRO-1 would shard the layer-stack dim ({spec})")
        return NamedSharding(mesh, P(*spec[1:]))

    m = unflatten(params_shape, [mom(pr, sh) for pr, sh in zip(order, leaves(p_shardings))])
    return {"m": m, "v": m, "step": NamedSharding(mesh, P())}


class _Shape:
    def __init__(self, shape):
        self.shape = shape


@torch.no_grad()
def adamw_update_sharded(grads: Any, opt_state: dict, params: Any, cfg: AdamWConfig,
                         spmd) -> tuple[Any, dict, dict]:
    """:func:`adamw_update` on placed state: ``params``, ``opt_state["m"]``
    and ``["v"]`` are DTensors (ZeRO-1 moments may shard a dim the param
    does not), ``opt_state["step"]`` a replicated DTensor, ``grads`` this
    rank's gradient shards in the params' layout, each already summed over
    its copies. Returns placed (new_params, new_opt_state, metrics). The
    global norm sums each leaf's squares over the axes it is sharded on; on
    a 1x1 mesh every op is :func:`adamw_update`'s."""
    from ..sharding.spmd import reshard, spec_of, sum_over

    flat_p = leaves(params)
    p_specs = [spec_of(p) for p in flat_p]
    flat_g = leaves(grads)
    sq = [torch.sum(torch.square(g.float())) for g in flat_g]
    sq = sum_over(sq, [[a for e in s for a in spec_axes(e)] for s in p_specs], spmd)
    gnorm = torch.sqrt(sum(sq))
    step = opt_state["step"].to_local() + 1
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    new_p, new_m, new_v = [], [], []
    for p, spec, g, m, v in zip(flat_p, p_specs, flat_g, leaves(opt_state["m"]),
                                leaves(opt_state["v"])):
        m_spec = spec_of(m)
        g_m = reshard(g, spec, m_spec, spmd)
        p_m = reshard(p.to_local(), spec, m_spec, spmd)
        np_m, m2, v2 = _leaf_update(cfg, g_m, m.to_local(), v.to_local(), p_m,
                                    scale, lr, b1c, b2c)
        np_local = reshard(np_m, m_spec, spec, spmd)
        new_p.append(_like(p, np_local))
        new_m.append(_like(m, m2))
        new_v.append(_like(v, v2))
    new_opt = {"m": unflatten(opt_state["m"], new_m), "v": unflatten(opt_state["v"], new_v),
               "step": _like(opt_state["step"], step)}
    return unflatten(params, new_p), new_opt, {"grad_norm": gnorm, "lr": lr}


def _like(d, local: torch.Tensor):
    """A DTensor with ``d``'s mesh, placements and shape holding ``local``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), d.device_mesh, d.placements,
                              run_check=False, shape=d.shape, stride=d.stride())
