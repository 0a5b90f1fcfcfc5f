"""Logical-axis sharding rules: parameter/activation paths -> PartitionSpecs.

The PyTorch counterpart of the JAX package's ``src/repro/sharding/rules.py``,
with its rules, gates and FSDP switch. Rules pattern-match the *last key*
of each parameter path and align to the trailing dims. A dim is only
sharded if its size is divisible by the product of the requested mesh axes
AND the whole tensor has at least ``min_shard_size`` elements, so small
tensors (norms, gates, tiny models) stay replicated.

TP layout: column-parallel in-projections (w_q/w_k/w_v/w_up/w_gate...),
row-parallel out-projections (w_o/w_down), vocab-sharded embedding + head,
expert-sharded MoE tensors (EP), everything else replicated. ZeRO-1 moment
shardings live in ``optim/adamw.py``.

Stacks. The reference holds each ``*_stack`` of layers as one leaf with a
leading ``[L, ...]`` axis; this package holds a list of per-layer dicts.
Three gates read the whole leaf (the size gate, the FSDP per-device total
and the FSDP size gate), so :func:`param_shardings` decides every gate on
the stacked shape the reference sees and gives each per-layer leaf the
reference's spec with the leading stack entry dropped.

A :class:`PartitionSpec` compares equal, entry by entry, to JAX's: each
entry is ``None``, an axis name, or a tuple of axis names (a one-axis tuple
is that axis's name, as JAX normalises it). :func:`placements` turns a spec
on a ``DeviceMesh`` into DTensor placements: a tensor dim over a tuple of
axes is ``Shard(dim)`` on each of those mesh dims, outermost first, which
is JAX's order when the tuple follows the mesh's axis order.

Meshes are anything with axis names and sizes: a ``torch`` ``DeviceMesh``
(``launch/mesh.py``) or an :class:`AbstractMesh`, which holds no process
and lets the rules run for a 512-device layout in one process.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any

from ..tree import leaves_with_paths, unflatten


class PartitionSpec(tuple):
    """A tuple of per-dim entries: None, an axis name or a tuple of names."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return p[0] if len(p) == 1 else p
            return p

        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices (the rules' view of a mesh)."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh or an AbstractMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return {name: mesh.size(i) for i, name in enumerate(axis_names(mesh))}


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order "
                             f"{names}; DTensor shards a dim over mesh dims in that order")
        for i in order:
            out[i] = Shard(dim)
    return tuple(out)


# (last-key regex, trailing spec) — first match wins. 'M' = model axis.
_RULES: list[tuple[str, tuple]] = [
    (r"^(embed)$", ("M", None)),
    (r"^(meta_tokens|pos_embed)$", (None, None)),
    (r"^(lm_head)$", (None, "M")),
    (r"^(w_q|w_k|w_v|w_uq|w_uk|w_uv|w_gate|w_up|w_if|w_b|w_c|w_dt|w_x)$", (None, "M")),
    (r"^(shared_gate|shared_up)$", (None, "M")),
    (r"^(w_o|w_down|shared_down)$", ("M", None)),
    (r"^(expert_gate|expert_up|expert_down)$", ("M", None, None)),
    (r"^(w_dq|w_dkv|router|mtp_proj)$", (None, None)),
    (r"^(r_h)$", (None, None, None)),
]


def spec_for_param(
    path: str,
    shape: tuple[int, ...],
    *,
    model_axis: str | tuple[str, ...] = "model",
    model_size: int = 1,
    min_shard_size: int = 256,
) -> PartitionSpec:
    key = path.split("/")[-1]
    for pattern, trailing in _RULES:
        if re.match(pattern, key):
            spec = [None] * (len(shape) - len(trailing)) + [
                (model_axis if t == "M" else None) for t in trailing
            ]
            # divisibility gate per dim; size gate on the whole tensor (a
            # 64-expert dim on a huge tensor must still shard)
            total = math.prod(shape) if shape else 0
            for i, ax in enumerate(spec):
                if ax is None:
                    continue
                if shape[i] % model_size or total < min_shard_size:
                    spec[i] = None
            return P(*spec)
    return P()  # replicated (norms, biases, scalars)


def stacked_view(params: Any) -> tuple[dict, list[tuple[str, str]]]:
    """The reference's view of a parameter tree: ``{reference path: (shape,
    itemsize)}``, each ``*_stack`` list of L per-layer dicts seen as one
    leaf ``[L, ...]`` per key, and ``(path, reference path)`` for every
    leaf of ``params`` in leaf order."""
    view: dict = {}
    order = []
    for path, leaf in leaves_with_paths(params):
        parts = path.split("/")
        if len(parts) > 2 and parts[0].endswith("_stack") and parts[1].isdigit():
            ref = "/".join([parts[0], *parts[2:]])
            if ref not in view:
                layers = len(params[parts[0]])
                view[ref] = ((layers, *leaf.shape), leaf.dtype.itemsize, True)
        else:
            ref = path
            view[ref] = (tuple(leaf.shape), leaf.dtype.itemsize, False)
        order.append((path, ref))
    return view, order


def param_shardings(
    params_shape: Any,
    mesh,
    *,
    model_axis: str = "model",
    min_shard_size: int = 256,
    fsdp_threshold_bytes: float = 4e9,
    force_fsdp: bool | None = None,
    replicate_patterns: tuple[str, ...] = (),
    expert_axes: tuple[str, ...] | None = None,
) -> Any:
    """NamedShardings for a params tree (of tensors, or meta tensors that
    only carry shape and dtype), in the tree's structure.

    If the TP-sharded per-device parameter footprint exceeds
    ``fsdp_threshold_bytes``, large tensors additionally shard their biggest
    free dim over the data axes (FSDP/ZeRO-3), as the reference does. Every
    gate is decided on the reference's stacked shapes; a per-layer leaf of
    a stack gets that spec less its leading (stack) entry.
    """
    sizes = axis_sizes(mesh)
    model_size = sizes[model_axis]
    data_axes = tuple(a for a in axis_names(mesh) if a != model_axis)
    dsize = math.prod(sizes[a] for a in data_axes)
    ep_size = math.prod(sizes[a] for a in expert_axes) if expert_axes else 0
    view, order = stacked_view(params_shape)

    def base_spec(path, shape):
        key = path.split("/")[-1]
        ndim = len(shape)
        if any(re.match(p, key) for p in replicate_patterns):
            return P(*([None] * ndim))
        if expert_axes is not None:
            # full-EP serving layout: expert/shared-FFN tensors sharded over
            # every mesh axis (weights stationary; see models/build.py)
            if re.match(r"^(expert_gate|expert_up|expert_down)$", key):
                if shape[-3] % ep_size == 0:
                    return P(*([None] * (ndim - 3)), expert_axes, None, None)
            if re.match(r"^(shared_gate|shared_up)$", key):
                if shape[-1] % ep_size == 0:
                    return P(*([None] * (ndim - 1)), expert_axes)
            if re.match(r"^(shared_down)$", key):
                if shape[-2] % ep_size == 0:
                    return P(*([None] * (ndim - 2)), expert_axes, None)
        return spec_for_param(path, shape, model_axis=model_axis,
                              model_size=model_size, min_shard_size=min_shard_size)

    def per_dev_bytes(shape, itemsize, spec):
        n = math.prod(shape)
        for ax in spec:
            if ax == model_axis:
                n //= model_size
        return n * itemsize

    base = {ref: base_spec(ref, shape) for ref, (shape, _, _) in view.items()}
    total_per_dev = sum(per_dev_bytes(shape, itemsize, base[ref])
                        for ref, (shape, itemsize, _) in view.items())
    use_fsdp = (force_fsdp if force_fsdp is not None
                else total_per_dev > fsdp_threshold_bytes)

    def final_spec(ref):
        shape = view[ref][0]
        spec = list(base[ref])
        spec += [None] * (len(shape) - len(spec))
        used = {a for s in spec for a in spec_axes(s)}
        if (use_fsdp and math.prod(shape) >= 2**20
                and not any(a in used for a in data_axes)):
            best, best_size = -1, 0
            for i, (ax, dim) in enumerate(zip(spec, shape)):
                if ax is None and dim % dsize == 0 and dim > best_size:
                    best, best_size = i, dim
            if best >= 0:
                spec[best] = data_axes if len(data_axes) > 1 else data_axes[0]
        return P(*spec)

    final = {ref: final_spec(ref) for ref in view}

    def per_leaf(ref):
        spec = final[ref]
        if not view[ref][2]:
            return NamedSharding(mesh, spec)
        if spec and spec[0] is not None:
            raise ValueError(f"{ref}: the reference shards the layer-stack dim "
                             f"({spec}), which per-layer leaves cannot hold")
        return NamedSharding(mesh, P(*spec[1:]))

    return unflatten(params_shape, [per_leaf(ref) for _, ref in order])


def batch_shardings(batch_specs: Any, mesh, data_axes: tuple[str, ...]) -> Any:
    """Inputs: shard dim0 (global batch) over the data axes when divisible."""
    sizes = axis_sizes(mesh)
    dsize = math.prod(sizes[a] for a in data_axes)

    def spec(leaf):
        if len(leaf.shape) >= 1 and leaf.shape[0] % dsize == 0 and leaf.shape[0] >= dsize:
            return NamedSharding(mesh, P(data_axes, *([None] * (len(leaf.shape) - 1))))
        return NamedSharding(mesh, P())

    return _map(spec, batch_specs)


@dataclass(frozen=True)
class StackedSharding:
    """A per-layer leaf of a layer stack's cache: layer ``layer`` of
    ``layers`` under ``spec``, the reference's spec for the stacked leaf
    ``[layers, ...]`` (its first entry splits the layers)."""

    mesh: Any
    spec: PartitionSpec
    layer: int
    layers: int

    def local_slices(self, shape: tuple[int, ...], coord: dict[str, int]
                     ) -> list[tuple[int, int]] | None:
        """(start, length) per dim of the part of this layer's leaf (of
        ``shape``) that the rank at ``coord`` holds; None when it holds
        none of the layer."""
        sizes = axis_sizes(self.mesh)
        spec = tuple(self.spec) + (None,) * (len(shape) + 1 - len(self.spec))
        start, n = shard_range(spec[0], self.layers, sizes, coord)
        if not start <= self.layer < start + n:
            return None
        return [shard_range(e, dim, sizes, coord) for e, dim in zip(spec[1:], shape)]


def shard_range(entry, dim: int, sizes: dict[str, int], coord: dict[str, int]
                ) -> tuple[int, int]:
    """(start, length) of the chunk of a dim of size ``dim`` that the rank
    at ``coord`` holds under one spec entry (row-major over its axes)."""
    idx, n = 0, 1
    for a in spec_axes(entry):
        idx, n = idx * sizes[a] + coord[a], n * sizes[a]
    return idx * (dim // n), dim // n


def cache_shardings(
    caches: Any,
    mesh,
    data_axes: tuple[str, ...],
    *,
    model_axis: str = "model",
    seq_dim_by_rank: dict[int, int] | None = None,
) -> Any:
    """Decode caches: batch dim over data axes; if batch is unshardable
    (long-context batch=1), shard the sequence dim over the model axis (cache
    sequence-parallelism) — and over everything for 500k caches.

    A ``*_stack`` list of per-layer caches (this package's layout of the
    reference's stacked ``[L, ...]`` leaves) is decided on the stacked
    shape, as the reference sees it, and each layer's leaf gets a
    :class:`StackedSharding`: dim 0 of the stacked leaf is then the layers,
    so where the data axes divide L they split the layers, and otherwise a
    long sequence dim goes over every axis (the batch stays whole)."""
    sizes = axis_sizes(mesh)
    dsize = math.prod(sizes[a] for a in data_axes)
    msize = sizes[model_axis]

    def spec(shape: tuple[int, ...]) -> PartitionSpec:
        nd = len(shape)
        parts: list = [None] * nd
        if nd >= 1 and shape[0] % dsize == 0 and shape[0] >= dsize:
            parts[0] = data_axes
            # additionally shard long sequence dims over model
            for i in range(1, nd):
                if shape[i] >= 16_384 and shape[i] % msize == 0:
                    parts[i] = model_axis
                    break
        else:
            # batch unshardable: find a long dim to shard over everything
            for i in range(1, nd):
                if shape[i] >= 16_384 and shape[i] % (dsize * msize) == 0:
                    parts[i] = (*data_axes, model_axis)
                    break
                if shape[i] >= 16_384 and shape[i] % msize == 0:
                    parts[i] = model_axis
                    break
        return P(*parts)

    def stacked(layers: list) -> list:
        one = layers[0]
        specs = [spec((len(layers), *leaf.shape)) for leaf in one]
        return [type(one)(*(StackedSharding(mesh, sp, i, len(layers)) for sp in specs))
                for i in range(len(layers))]

    if isinstance(caches, dict):
        return {k: (stacked(v) if k.endswith("_stack") and isinstance(v, list)
                    else _map(lambda leaf: NamedSharding(mesh, spec(tuple(leaf.shape))), v))
                for k, v in caches.items()}
    return _map(lambda leaf: NamedSharding(mesh, spec(tuple(leaf.shape))), caches)


def _map(fn, tree: Any) -> Any:
    """``fn`` over the leaves of a tree of dicts, lists and tuples (a
    NamedTuple cache keeps its type), or over one leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)
