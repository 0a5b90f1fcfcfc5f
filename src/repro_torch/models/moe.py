"""Mixture-of-Experts FFN (DeepSeek-style), on one device or expert-parallel.

The PyTorch counterpart of the JAX package's ``src/repro/models/moe.py``.
Routing: top-k over router scores (softmax or sigmoid per config), optional
shared experts that always fire, capacity-bounded dispatch (assignments
over an expert's capacity are dropped: GShard/Switch semantics) and a
Switch-style load-balance auxiliary loss.

Token -> buffer slots come from the reference's sort-and-rank trick: a
stable sort of the flat ``[T*k]`` expert ids, so that within an expert the
earlier assignment takes the lower slot and the same assignments fall past
``capacity`` as in the reference. Every expert then runs a SwiGLU over its
``capacity`` slots as one batched matmul (the reference's capacity-buffer
design: a decode step reads every expert's weights).

The dispatch writes each kept assignment's row into its own slot (slots are
unique), and dropped assignments into a spare row past the last slot that
is never read; the combine sums each token's k weighted expert outputs in
their top-k order, one add at a time in the input dtype, as the reference's
scatter-add does. No float atomics are involved, so a forward gives the
same bits every run, and no step reads a value back to the host.

Expert parallelism (the reference's ``shard_map`` island): with
``model_axis`` and ``mesh`` (a ``sharding.spmd.Spmd``), ``params`` holds
this rank's ``E/shards`` experts (and its share of the shared experts'
width), the shard index is this rank's coordinate over ``model_axis`` in
the reference's axis order, capacity comes from the local tokens, and the
output is all-reduced over the EP ranks. Over one shard the ops are those
of the single-device path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding.spmd import all_reduce
from .layers import dense_param


def moe_init(gen: torch.Generator, cfg, dtype, device) -> dict:
    """Router (f32), stacked expert SwiGLU weights [E, d, f] / [E, f, d]
    and, with ``num_shared``, one shared SwiGLU of width ``f * num_shared``
    (the reference's init distributions; torch's numbers, not JAX's)."""
    m = cfg.moe
    d, f, e = cfg.d_model, cfg.moe_d_ff, m.num_experts

    def experts(shape, fan_in):
        # scaled in place: V3's [256, 7168, 2048] is 15 GB in f32
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)

    p = {
        "router": dense_param(gen, d, e, torch.float32, device),
        "expert_gate": experts((e, d, f), d),
        "expert_up": experts((e, d, f), d),
        "expert_down": experts((e, f, d), f),
    }
    if m.num_shared > 0:
        fs = f * m.num_shared
        p["shared_gate"] = dense_param(gen, d, fs, dtype, device)
        p["shared_up"] = dense_param(gen, d, fs, dtype, device)
        p["shared_down"] = dense_param(gen, fs, d, dtype, device)
    return p


def _routing(params: dict, x_flat: torch.Tensor, cfg):
    """Top-k routing of ``x_flat`` [T, d]: (expert ids [T, k] in descending
    score order, f32 gates [T, k], the f32 aux loss)."""
    m = cfg.moe
    logits = x_flat.float() @ params["router"]
    if m.score_fn == "sigmoid":           # deepseek-v3
        scores = torch.sigmoid(logits)
    else:                                  # softmax (deepseek-moe-16b)
        scores = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(scores, m.top_k, dim=-1, sorted=True)
    if m.normalize_gates:
        top_vals = top_vals / (top_vals.sum(-1, keepdim=True) + 1e-9)
    top_vals = top_vals * m.routed_scale
    # Switch-style load-balance aux loss: the fraction of tokens routed to
    # each expert (the reference's one-hot sum, as a count: exact in f32,
    # and with no host sync, unlike bincount) times its mean normalised score
    e = m.num_experts
    flat = top_idx.reshape(-1)
    counts = torch.zeros(e, device=x_flat.device).index_add_(
        0, flat, torch.ones(flat.shape, device=x_flat.device))
    density = counts / x_flat.shape[0]
    mean_prob = (scores / scores.sum(-1, keepdim=True)).mean(0)
    aux = e * torch.sum(density * mean_prob) * m.aux_loss_coef
    return top_idx, top_vals.float(), aux


def _dispatch_slots(expert_ids: torch.Tensor, capacity: int):
    """Rank of each assignment within its expert (a stable sort, as
    ``jnp.argsort``); returns (slots int32, slots < capacity)."""
    tk = expert_ids.shape[0]
    sorted_e, order = torch.sort(expert_ids, stable=True)
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = torch.arange(tk, device=expert_ids.device) - seg_start
    slots = torch.empty(tk, dtype=torch.int32, device=expert_ids.device)
    slots[order] = rank_sorted.to(torch.int32)
    return slots, slots < capacity


def moe_ffn(params: dict, x: torch.Tensor, cfg, *, model_axis=None,
            mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of ``x`` [b, s, d]; returns (out [b, s, d], aux).

    With ``model_axis`` (an axis name, or a tuple of them: experts over
    every axis) and ``mesh``, ``params`` holds this rank's experts and the
    output is summed over those axes' ranks."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    x_flat = x.reshape(t, d)
    top_idx, gates, aux = _routing(params, x_flat, cfg)      # [T, k]

    e, k = m.num_experts, m.top_k
    shard = mesh.index(model_axis) if model_axis is not None else 0
    e_loc = params["expert_up"].shape[0]                     # E/shards
    capacity = max(8, int(t * k * m.capacity_factor) // e)
    flat_e = top_idx.reshape(-1)                             # [T*k]
    flat_gate = gates.reshape(-1)
    flat_tok = torch.arange(t * k, device=x.device) // k
    slots, in_cap = _dispatch_slots(flat_e, capacity)
    # kept here: within capacity and one of this shard's experts
    kept = in_cap & ((flat_e // e_loc) == shard)
    lin = (flat_e % e_loc) * capacity + slots                 # unique where kept

    # dispatch: kept rows into their slots, dropped ones into the spare row
    spare = e_loc * capacity
    buf = x.new_zeros((spare + 1, d)).index_copy(
        0, torch.where(kept, lin, spare), x_flat[flat_tok])
    buf = buf[:spare].view(e_loc, capacity, d)

    # batched expert SwiGLU
    g = F.silu(torch.bmm(buf, params["expert_gate"]))
    u = torch.bmm(buf, params["expert_up"])
    h_flat = torch.bmm(g * u, params["expert_down"]).view(spare, d)

    # combine: gather back (dropped: row 0 at weight 0, as the reference),
    # weight by gate, add each token's k contributions in a fixed order
    weight = torch.where(kept, flat_gate, 0.0)
    contrib = (h_flat[torch.where(kept, lin, 0)]
               * weight[:, None].to(x.dtype)).view(t, k, d)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]

    if m.num_shared > 0:
        # shared expert(s): d_ff sharded like the experts => partial sums
        sg = F.silu(x_flat @ params["shared_gate"])
        su = x_flat @ params["shared_up"]
        out = out + (sg * su) @ params["shared_down"]

    if model_axis is not None:
        out = all_reduce(out, mesh, model_axis)
    return out.reshape(b, s, d), aux
