"""Elastic re-meshing: resume a run on a different number of ranks.

The PyTorch counterpart of the JAX package's ``src/repro/runtime/elastic.py``.
The checkpoint format is mesh-agnostic (whole logical arrays), so
elasticity reduces to: build a new mesh from the surviving ranks, recompute
shardings for that mesh (the same rules scale to any axis sizes), and
``restore`` with the new shardings. The math picks the largest (data x
model) grid that fits the survivors, preferring to shrink the data axis
first (keeps TP layouts, only changes the gradient-reduction span).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ..sharding import NamedSharding, P, param_shardings
from ..tree import tree_map


def best_mesh_shape(n_devices: int, *, model_parallel: int) -> tuple[int, int]:
    """(data, model) for the surviving device count; model axis preserved
    while possible, else reduced to the largest divisor that fits."""
    model = min(model_parallel, n_devices)
    while model > 1 and (n_devices % model or model > n_devices):
        model -= 1
    data = n_devices // model
    return data, model


def remesh(
    ranks: Sequence[int],
    *,
    model_parallel: int,
    axis_names: tuple[str, str] = ("data", "model"),
    device_type: str | None = None,
):
    """A ``DeviceMesh`` over the first data x model of ``ranks`` (the
    survivors' global ranks in the default process group, which every one
    of its ranks must call this with); ``device_type`` as in
    ``launch.mesh.make_mesh``."""
    from torch.distributed.device_mesh import DeviceMesh

    from ..launch.mesh import default_device_type

    data, model = best_mesh_shape(len(ranks), model_parallel=model_parallel)
    usable = torch.tensor(list(ranks)[: data * model]).reshape(data, model)
    return DeviceMesh(device_type or default_device_type(), usable,
                      mesh_dim_names=axis_names)


def reshard_state(state_like: Any, mesh, params_key: str = "params") -> Any:
    """Shardings tree for a {params, opt, step} state on the new mesh."""
    out = {}
    for key, sub in state_like.items():
        if key == params_key:
            out[key] = param_shardings(sub, mesh)
        else:
            out[key] = tree_map(lambda _: NamedSharding(mesh, P()), sub)
    return out
