"""Mesh construction on ``torch.distributed``.

The PyTorch counterpart of the JAX package's ``src/repro/launch/mesh.py``:
the same shapes and axis names, as a ``DeviceMesh`` from
``init_device_mesh``. Single-pod: 16x16 = 256 ranks ("data", "model").
Multi-pod: 2x16x16 = 512 ranks ("pod", "data", "model"); the pod axis is
the cross-pod data-parallel axis, where gradient compression applies.

A function, not a module-level constant: importing this module touches no
process group. The caller initialises the default process group first
(``torch.distributed.init_process_group`` with its address, world size and
rank); a world size that does not equal the mesh's size raises. The
device type is ``cuda`` wherever a card is present, whatever the backend
(gloo carries CUDA tensors through the host), else ``cpu``; a caller that
wants CPU tensors beside a card asks for ``device_type="cpu"``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def default_device_type() -> str:
    """``cuda`` when a card is present, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group's
    ranks in row-major order; raises unless the world size is the mesh's."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {math.prod(shape)} "
                         f"ranks; the world has {world}")
    device_type = device_type or default_device_type()
    if device_type == "cuda":
        # every rank of this host on its card; several ranks may share one
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def data_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, device_type: str | None = None):
    """Small mesh for tests and for several ranks on one card."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type=device_type)
