"""Local-shard compute on a ``DeviceMesh``: collectives with their adjoints,
and moving a shard from one spec to another.

The JAX package lets XLA partition a program from its shardings (GSPMD) and
writes its one explicit island with ``shard_map`` and ``psum``. This
package runs the same program on each rank's shards, with explicit
collectives over the mesh's process groups. The rules of that program:

* every rank runs the same ops in the same order, so collectives pair up;
* a value replicated over an axis is computed on each rank of that axis
  from replicated inputs, and a parameter replicated over an axis has one
  copy per rank;
* each collective's gradient is its true adjoint: ``all_reduce``'s is an
  ``all_reduce``, ``all_gather``'s a reduce-scatter (here an
  ``all_reduce`` and the rank's chunk); a local chunk's is a zero pad;
* the step seeds each rank's backward with ``1 / world`` of its local loss
  (each rank's loss is the mean over its data shard, equal on the ranks of
  one model group) and sums each parameter's gradient over the mesh axes it
  is replicated on (:func:`sum_replicated`).

That is reverse-mode differentiation of the whole multi-rank program, so
the gradients are those of the global loss whatever the layout. A
collective over an axis of size 1 is skipped: on a 1x1 mesh the ops are
those of the unsharded path, bit for bit.

Collectives use ``all_reduce`` and ``all_gather`` (a list) only: gloo
carries both for CPU and CUDA tensors (``tools/dist_probe.py``). The placed
state is DTensors, their placements those of ``rules.placements``, used as
containers only (``from_local``, ``to_local``): DTensor's own collectives
never return over gloo with CUDA tensors, so :func:`to_spec`,
:func:`place` and :func:`full_tensor` move shards with the functions here.
Every collective goes through ``torch.distributed``'s ops, so
``roofline.analysis.record_collectives`` sees each one (one per mesh axis
of a multi-axis reduce or gather) with its output bytes.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .rules import P, PartitionSpec, axis_names, axis_sizes, spec_axes


class Spmd:
    """This rank's view of a mesh: axis sizes, its coordinates and the
    process group of each axis."""

    def __init__(self, mesh, *, data_axes=("data",), model_axis: str = "model"):
        self.mesh = mesh
        self.names = axis_names(mesh)
        self.sizes = axis_sizes(mesh)
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self.coord = dict(zip(self.names, coord))
        self.data_axes = tuple(data_axes)
        self.model_axis = model_axis

    @property
    def world(self) -> int:
        return math.prod(self.sizes.values())

    def size(self, axes) -> int:
        return math.prod(self.sizes[a] for a in _axes(axes))

    def index(self, axes) -> int:
        """This rank's index over ``axes``, outermost first (row-major)."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.sizes[a] + self.coord[a]
        return idx

    def group(self, axis: str):
        return self.mesh.get_group(axis)


def _axes(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


# ------------------------------------------------------------ collectives

def _reduce(x: torch.Tensor, spmd: Spmd, axes) -> torch.Tensor:
    if spmd.size(axes) == 1:
        return x
    y = x.contiguous().clone()
    for a in _axes(axes):
        if spmd.sizes[a] > 1:
            dist.all_reduce(y, group=spmd.group(a))
    return y


def _gather(x: torch.Tensor, spmd: Spmd, axes, dim: int) -> torch.Tensor:
    # innermost axis first, so the chunks land in row-major order
    for a in reversed(_axes(axes)):
        n = spmd.sizes[a]
        if n > 1:
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=spmd.group(a))
            x = torch.cat(parts, dim=dim)
    return x


def chunk(x: torch.Tensor, spmd: Spmd, axes, dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` over ``axes`` (no
    communication; its gradient pads with zeros)."""
    n = spmd.size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {list(x.shape)} does not split over {axes} ({n})")
    size = x.shape[dim] // n
    return x.narrow(dim, spmd.index(axes) * size, size)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spmd, axes):
        ctx.spmd, ctx.axes = spmd, axes
        return _reduce(x, spmd, axes)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.spmd, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spmd, axes, dim):
        ctx.spmd, ctx.axes, ctx.dim = spmd, axes, dim
        return _gather(x, spmd, axes, dim)

    @staticmethod
    def backward(ctx, g):
        g = _reduce(g, ctx.spmd, ctx.axes)
        return chunk(g, ctx.spmd, ctx.axes, ctx.dim).contiguous(), None, None, None


def all_reduce(x: torch.Tensor, spmd: Spmd, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (identity over size 1)."""
    if spmd.size(axes) == 1:
        return x
    return _AllReduce.apply(x, spmd, _axes(axes))


def all_gather(x: torch.Tensor, spmd: Spmd, axes, dim: int) -> torch.Tensor:
    """The chunks of ``x`` over ``axes`` concatenated along ``dim`` in
    row-major order of the axes (identity over size 1)."""
    if spmd.size(axes) == 1:
        return x
    return _AllGather.apply(x, spmd, _axes(axes), dim % x.dim())


def all_max(x: torch.Tensor, spmd: Spmd, axes) -> torch.Tensor:
    """The elementwise max over ``axes``; no gradient (a stabiliser)."""
    if spmd.size(axes) == 1:
        return x
    with torch.no_grad():
        return _gather(x.unsqueeze(0), spmd, axes, 0).amax(0)


def combine_softmax(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, spmd: Spmd,
                    axes) -> torch.Tensor:
    """Softmax-weighted values from partial results over disjoint sets of
    keys on the ranks of ``axes``: each rank's row max ``m`` [...], sum of
    ``exp(score - m)`` ``l`` [...] and values weighted by those terms ``o``
    [..., d] (a rank with no keys gives -inf, 0 and 0). Returns sum(o) /
    sum(l) with every part rescaled to the global max."""
    mx = all_max(m, spmd, axes)
    scale = torch.exp(m - mx)
    return all_reduce(o * scale[..., None], spmd, axes) / all_reduce(l * scale, spmd, axes)[..., None]


# ----------------------------------------------------------- shards by spec

def reshard(t: torch.Tensor, spec, target, spmd: Spmd) -> torch.Tensor:
    """``t``, this rank's shard under ``spec``, as its shard under
    ``target``: each dim whose axes differ is gathered whole, then chunked
    by the target's axes. Values are unchanged; differentiable."""
    n = t.dim()
    spec = tuple(spec) + (None,) * (n - len(spec))
    target = tuple(target) + (None,) * (n - len(target))
    for dim, (cur, want) in enumerate(zip(spec, target)):
        if spec_axes(cur) == spec_axes(want):
            continue
        t = all_gather(t, spmd, spec_axes(cur), dim)
        t = chunk(t, spmd, spec_axes(want), dim)
    return t


def to_spec(d, target, spmd: Spmd) -> torch.Tensor:
    """This rank's shard of DTensor ``d`` under ``target`` (a plain tensor,
    differentiable through ``d.to_local()``)."""
    return reshard(d.to_local(), spec_of(d), target, spmd)


# ------------------------------------------------------- the placed state

def spec_of(d) -> PartitionSpec:
    """The spec of DTensor ``d``'s placements on its mesh (mesh order
    within a dim, as :func:`rules.placements` writes it)."""
    from torch.distributed.tensor import Shard

    names = axis_names(d.device_mesh)
    dims: dict[int, list[str]] = {}
    for name, pl in zip(names, d.placements):
        if isinstance(pl, Shard):
            dims.setdefault(pl.dim, []).append(name)
    if not dims:
        return P()
    return P(*(tuple(dims.get(d, ())) or None for d in range(max(dims) + 1)))


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(full: torch.Tensor, sharding, spmd: Spmd | None = None):
    """A DTensor of ``full`` (the same on every rank) under a
    ``NamedSharding``: each rank keeps its chunk, no communication."""
    from torch.distributed.tensor import DTensor

    spmd = spmd or Spmd(sharding.mesh)
    local = reshard(full, P(), sharding.spec, spmd)
    return DTensor.from_local(local.contiguous(), sharding.mesh, sharding.placements,
                              run_check=False, shape=full.shape, stride=full.stride())


def full_tensor(d, spmd: Spmd | None = None) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank (a collective over its
    sharded axes); a plain tensor comes back as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(d, DTensor):
        return d
    return to_spec(d, P(), spmd or Spmd(d.device_mesh))


def sum_over(values: list, axes: list, spmd: Spmd) -> list:
    """Each tensor of ``values`` summed over its own mesh axes (``axes[i]``,
    any order); tensors with the same axes and dtype share one
    ``all_reduce`` of their concatenation."""
    out = list(values)
    buckets: dict = {}
    for i, (v, ax) in enumerate(zip(values, axes)):
        ax = tuple(a for a in spmd.names if a in ax and spmd.sizes[a] > 1)
        if ax:
            buckets.setdefault((ax, v.dtype, v.device), []).append(i)
    for (ax, _, _), idx in buckets.items():
        flat = _reduce(torch.cat([values[i].reshape(-1) for i in idx]), spmd, ax)
        for i, part in zip(idx, flat.split([values[i].numel() for i in idx])):
            out[i] = part.view(values[i].shape)
    return out


def sum_replicated(grads: list, specs: list, spmd: Spmd) -> list:
    """Parameters' local gradients, each summed over the mesh axes its spec
    does not shard it over (its copies on those ranks)."""
    return sum_over(grads, [[a for a in spmd.names
                             if a not in {x for e in s for x in spec_axes(e)}]
                            for s in specs], spmd)
