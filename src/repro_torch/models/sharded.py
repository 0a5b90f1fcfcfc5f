"""The decoder LM on each rank's shards (``build_model`` with a mesh).

The counterpart of the JAX package's ``models/build.py`` when it is given
a mesh: there XLA partitions the loss from the parameter shardings, and
the MoE FFN is a ``shard_map`` island. Here every rank runs
``build.lm_loss`` itself on its shards, with a :class:`TensorParallel` as
its ``tp``; the blocks and the loss are build.py's, and the hooks below
only take weights to the layout each layer runs on and sum partial outputs
(``sharding/spmd.py`` says how gradients follow):

* activations ``[b, s, d]`` hold this rank's batch shard (the data axes)
  and are whole over the model axis between layers, where the reference's
  ``activation_constraints`` pin them (``P(data_axes, None, None)``): each
  row-parallel output is summed over the model axis, so those constraints
  hold by construction and move nothing;
* :meth:`TensorParallel.block` takes a layer's placed weights to local
  ones (an FSDP weight gathered over data): q/k/v columns and ``w_o`` rows
  by whole heads, so the flash kernels see the local heads ``[b, H/model,
  s, D]``, and the MLP's gate/up columns and down rows; a part whose heads
  (kv heads: whole GQA groups) or ``d_ff`` the model axis does not divide
  runs on whole weights on every rank, as does MLA;
* the embedding is looked up in this rank's vocab rows and summed over the
  model axis; the head gives this rank's vocab columns of the logits, and
  the cross-entropy takes its log-sum-exp and label logit through a max and
  two sums over the model axis, so the f32 logits are never whole;
* the MoE FFN is the reference's island: experts over ``model`` (or over
  every axis with ``cfg.ep_over_data``, activations gathered), capacity
  from the tokens the island sees, the aux loss averaged over the data
  axes.

Each rank's loss is the mean over its own tokens; the step averages it
over the data axes. On a 1x1 mesh every op is the single-device path's.

Serving (``build.lm_prefill`` and ``build.lm_decode_step`` with ``tp``)
takes the whole token batch on every rank and returns the whole logits
on every rank, as on one device. :meth:`TensorParallel.for_batch` says
whether a pass's rows split over the data axes (the reference's
``batch_shardings`` rule: when they divide the batch); each rank runs its
rows, and its heads as in training. The caches are
:class:`attention.PlacedCache` s: :meth:`TensorParallel.place_caches`
gives each layer's cache this rank's part of the placement the
reference's ``cache_shardings`` gives the stacked cache (every row and
head; the layers over the data axes where those divide them, a long
sequence over the model axis or over every axis), and
``models/attention.py`` writes and attends over it
(:meth:`gather_rows_heads` and :meth:`local_rows_heads` move a pass's
rows and heads). The MoE FFN of a serving pass is the training island;
with ``cfg.ep_over_data`` the experts lie over every axis and the
activations are whole on every rank, as in the reference's serving EP.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from ..sharding.rules import P, cache_shardings, spec_axes
from ..sharding.spmd import Spmd, all_gather, all_max, all_reduce, chunk, to_spec
from .attention import MLACache, PlacedCache
from .layers import cross_entropy_loss
from .moe import moe_ffn


def rows_split(spmd: Spmd, batch: int) -> bool:
    """Whether a batch of ``batch`` rows splits over the data axes (the
    reference's ``batch_shardings`` rule)."""
    n = spmd.size(spmd.data_axes)
    return batch % n == 0 and batch >= n


class TensorParallel:
    """The hooks ``build.lm_loss`` and ``build.block_apply`` call on this
    rank's shards of ``spmd``'s mesh (``tp``; None on one device)."""

    def __init__(self, cfg, spmd: Spmd):
        self.spmd = spmd
        m = self.model_axis = spmd.model_axis
        # with the model axis among the data axes (pure data parallelism,
        # the dry-run's batch_over_model) each rank runs whole weights
        n = 1 if m in spmd.data_axes else spmd.size(m)
        self.split_attn = n > 1 and cfg.mla is None and cfg.num_kv_heads % n == 0
        self.split_mlp = n > 1 and cfg.d_ff % n == 0
        self.split_vocab = n > 1 and cfg.vocab % n == 0
        # the config of this rank's heads, for gqa_attention's reshapes
        self.attn_cfg = (dataclasses.replace(cfg, num_heads=cfg.num_heads // n,
                                             num_kv_heads=cfg.num_kv_heads // n)
                         if self.split_attn else cfg)
        self.ep_over_data = cfg.ep_over_data
        ep = (*spmd.data_axes, m) if cfg.ep_over_data else m
        cols, rows = P(None, m), P(m, None)
        # each layer's local layout by sub-tree and key; the rest is whole
        self.layout = {"moe": {"expert_gate": P(ep, None, None),
                               "expert_up": P(ep, None, None),
                               "expert_down": P(ep, None, None),
                               "shared_gate": P(None, ep), "shared_up": P(None, ep),
                               "shared_down": P(ep, None)}}
        if self.split_attn:
            self.layout["attn"] = {"w_q": cols, "w_k": cols, "w_v": cols, "w_o": rows}
        if self.split_mlp:
            self.layout["mlp"] = {"w_gate": cols, "w_up": cols, "w_down": rows}
        self.rows_split = True      # training: the batch is this rank's shard

    def for_batch(self, batch: int) -> "TensorParallel":
        """These hooks for a serving pass over ``batch`` whole rows."""
        tp = copy.copy(self)
        tp.rows_split = rows_split(self.spmd, batch)
        return tp

    def _local(self, d, spec=P()) -> torch.Tensor:
        return to_spec(d, spec, self.spmd)

    # ------------------------------------------------------------ weights

    def top(self, params: dict) -> dict:
        """The leaves outside the layers as this rank uses them: the
        embedding's vocab rows and the head's vocab columns (whole when the
        model axis does not divide the vocab), the rest whole; the layer
        stacks and the MTP block stay placed (:meth:`block` takes each)."""
        vocab = self.model_axis if self.split_vocab else None
        out = {}
        for k, v in params.items():
            if k == "embed":
                out[k] = self._local(v, P(vocab, None))
            elif k == "lm_head":
                out[k] = self._local(v, P(None, vocab))
            elif isinstance(v, (list, dict)):
                out[k] = v
            else:
                out[k] = self._local(v)
        return out

    def block(self, p: dict) -> dict:
        """A layer's placed weights as the local tensors its layers run on."""
        return {k: ({kk: self._local(vv, self.layout.get(k, {}).get(kk, P()))
                     for kk, vv in v.items()} if isinstance(v, dict) else self._local(v))
                for k, v in p.items()}

    # ------------------------------------------------------------- hooks

    def reduce_attn(self, a: torch.Tensor) -> torch.Tensor:
        """The attention output: partial sums over the local heads, summed."""
        return all_reduce(a, self.spmd, self.model_axis) if self.split_attn else a

    def reduce_mlp(self, f: torch.Tensor) -> torch.Tensor:
        """The MLP output: partial sums over the local ``d_ff``, summed."""
        return all_reduce(f, self.spmd, self.model_axis) if self.split_mlp else f

    def moe(self, p: dict, h: torch.Tensor, cfg):
        """The reference's expert-parallel island on local experts: (out,
        aux)."""
        spmd, data = self.spmd, self.spmd.data_axes
        if self.ep_over_data:
            # serving EP: experts over every axis, activations whole
            out, aux = moe_ffn(p, self.gather_rows_heads(h, heads=False), cfg,
                               model_axis=(*data, self.model_axis), mesh=spmd)
            return self.local_rows_heads(out, heads=False), aux
        out, aux = moe_ffn(p, h, cfg, model_axis=self.model_axis, mesh=spmd)
        return out, all_reduce(aux, spmd, data) / spmd.size(data)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of ``tokens`` from this rank's vocab rows, summed over the
        model axis."""
        if not self.split_vocab:
            return table[tokens]
        m = self.model_axis
        v_loc = table.shape[0]
        loc = tokens.long() - self.spmd.index(m) * v_loc
        inside = (loc >= 0) & (loc < v_loc)
        rows = table[loc.clamp(0, v_loc - 1)]
        return all_reduce(rows * inside[..., None].to(rows.dtype), self.spmd, m)

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor, *,
                      z_loss: float = 1e-4) -> torch.Tensor:
        """``layers.cross_entropy_loss`` over this rank's vocab columns of
        the logits: the max, the sum of exponentials and the label's logit
        are reduced over the model axis; nothing of the vocab is gathered."""
        if not self.split_vocab:
            return cross_entropy_loss(logits, labels, z_loss=z_loss)
        spmd, m = self.spmd, self.model_axis
        lf = logits.float()
        mx = all_max(lf.detach().amax(-1), spmd, m)
        lse = mx + torch.log(all_reduce(torch.exp(lf - mx[..., None]).sum(-1), spmd, m))
        v_loc = lf.shape[-1]
        loc = labels.long() - spmd.index(m) * v_loc
        inside = (loc >= 0) & (loc < v_loc)
        ll = torch.gather(lf, -1, loc.clamp(0, v_loc - 1)[..., None])[..., 0]
        ll = all_reduce(torch.where(inside, ll, 0.0), spmd, m)
        loss = (lse - ll).mean()
        if z_loss:
            loss = loss + z_loss * (lse**2).mean()
        return loss

    # ------------------------------------------------------------ serving

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch."""
        return chunk(t, self.spmd, self.spmd.data_axes, 0) if self.rows_split else t

    def gather_rows_heads(self, t: torch.Tensor, heads: bool = True) -> torch.Tensor:
        """A pass's tensor [rows, heads, ...] of this rank as every rank's
        rows (dim 0, over the data axes when they split the rows) and,
        with ``heads``, heads (dim 1, over the model axis when it splits
        attention)."""
        if self.rows_split:
            t = all_gather(t, self.spmd, self.spmd.data_axes, 0)
        if heads and self.split_attn:
            t = all_gather(t, self.spmd, self.model_axis, 1)
        return t

    def local_rows_heads(self, t: torch.Tensor, heads: bool = True) -> torch.Tensor:
        """This rank's rows and (with ``heads``) heads of a whole tensor,
        the inverse of :meth:`gather_rows_heads` (no communication)."""
        t = self.rows(t)
        if heads and self.split_attn:
            t = chunk(t, self.spmd, self.model_axis, 1)
        return t

    def whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits [rows, vocab] of this rank's rows and vocab columns as
        the whole batch's over the whole vocab."""
        if self.split_vocab:
            logits = all_gather(logits, self.spmd, self.model_axis, -1)
        if self.rows_split:
            logits = all_gather(logits, self.spmd, self.spmd.data_axes, 0)
        return logits

    def place_caches(self, template: dict, device) -> dict:
        """This rank's :class:`PlacedCache` of every layer of ``template``
        (``{stack: [cache of meta tensors, one a layer]}``, the whole
        caches' shapes), zero-filled on ``device``."""
        spmd = self.spmd
        shardings = cache_shardings(template, spmd.mesh, spmd.data_axes,
                                    model_axis=self.model_axis)
        out = {}
        for name, layers in template.items():
            out[name] = []
            for one, sh in zip(layers, shardings[name]):
                slot_dim = 1 if isinstance(one, MLACache) else 2
                length = one[0].shape[slot_dim]
                parts = sh[0].local_slices(tuple(one[0].shape), spmd.coord)
                for d, (_, n) in enumerate(parts or ()):
                    if d != slot_dim and n != one[0].shape[d]:
                        raise NotImplementedError(f"{name}: a cache split along dim {d} "
                                                  f"({sh[0].spec}) is not served")
                slot0, held = parts[slot_dim] if parts else (0, 0)
                spec = sh[0].spec
                split = tuple(a for e in (spec[0], spec[1 + slot_dim])
                              for a in spec_axes(e) if spmd.sizes[a] > 1)
                local = type(one)(*(
                    torch.zeros((*t.shape[:slot_dim], held, *t.shape[slot_dim + 1:]),
                                dtype=t.dtype, device=device) for t in one))
                out[name].append(PlacedCache(local, slot0, length, split))
        return out
