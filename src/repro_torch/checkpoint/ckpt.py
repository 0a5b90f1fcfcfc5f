"""Async, versioned checkpointing (no external deps).

The PyTorch counterpart of the JAX package's ``src/repro/checkpoint/ckpt.py``,
with its on-disk layout: ``<dir>/step_<n>/arrays.npz`` + ``manifest.json``,
written to a temp dir and atomically renamed, so a crash mid-write never
corrupts the latest step; ``keep`` most recent steps are kept. A leaf's key
is its tree path (``params/dense_stack/3/attn/w_q``; ``|`` for ``/`` inside
the npz). ``AsyncCheckpointer.save_async`` snapshots to host memory
synchronously (a device-to-host copy) and writes on a background thread.

numpy has no bfloat16: a bf16 leaf is stored as its 16-bit pattern
(uint16) and the manifest names its dtype, so a restore is bit-exact and
the file is no larger than the tensor. Restore places every leaf on the
device and dtype of the matching leaf of ``like``, or, given
``shardings``, as a DTensor under its sharding.

The format is mesh-agnostic (whole logical arrays), so a checkpoint
written on one mesh restores onto another (elastic re-meshing,
``runtime/elastic.py``). Under ``torch.distributed`` a DTensor leaf is
gathered whole on every rank (a collective: every rank saves), rank 0
writes, and ``wait`` ends with a barrier, so a restore on any rank after
it reads the finished step.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..sharding.spmd import full_tensor, mesh_device, place
from ..tree import leaves, leaves_with_paths, unflatten


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _writes() -> bool:
    """Whether this process writes checkpoints (rank 0 of a group, or alone)."""
    return not _distributed() or dist.get_rank() == 0


def _flatten(tree: Any) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Host copies of the leaves by path (a DTensor gathered whole), and each
    leaf's dtype name."""
    flat, dtypes = {}, {}
    for path, leaf in leaves_with_paths(tree):
        t = full_tensor(leaf)
        t = torch.as_tensor(t).detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[path] = t.view(torch.int16).numpy().view(np.uint16)
            dtypes[path] = "bfloat16"
        else:
            flat[path] = t.numpy()
            dtypes[path] = str(flat[path].dtype)
    return flat, dtypes


def _write(ckpt_dir: str, step: int, flat: dict, dtypes: dict, keep: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **{k.replace("/", "|"): v for k, v in flat.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(
            {
                "step": step,
                "keys": sorted(flat),
                "shapes": {k: list(v.shape) for k, v in flat.items()},
                "dtypes": dtypes,
            },
            f,
        )
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Synchronous atomic save; returns the final directory."""
    flat, dtypes = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _writes():
        final = _write(ckpt_dir, step, flat, dtypes, keep)
    if _distributed():
        dist.barrier()
    return final


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, write on a daemon thread."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        flat, dtypes = _flatten(tree)   # device->host copy happens here, synchronously
        if not _writes():
            return

        def work():
            try:
                _write(self.ckpt_dir, step, flat, dtypes, self.keep)
            except Exception as e:  # pragma: no cover
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _distributed():
            dist.barrier()
        if self.last_error:
            raise self.last_error


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any, shardings: Any | None = None) -> Any:
    """Restore into the structure of ``like``: each leaf in the dtype of
    ``like``'s leaf at the same path, on its device, or, with
    ``shardings`` (a tree of NamedShardings like ``like``), placed as a
    DTensor under the leaf's sharding on its mesh."""
    root = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(root, "manifest.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    with np.load(os.path.join(root, "arrays.npz")) as data:
        flat = {k.replace("|", "/"): data[k] for k in data.files}

    def pick(path, leaf, sh):
        arr = flat[path]
        if dtypes.get(path) == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if sh is not None:
            return place(t.to(device=mesh_device(sh.mesh), dtype=leaf.dtype), sh)
        leaf = torch.as_tensor(leaf)
        return t.to(device=leaf.device, dtype=leaf.dtype)

    pairs = leaves_with_paths(like)
    shs = leaves(shardings) if shardings is not None else [None] * len(pairs)
    return unflatten(like, [pick(p, leaf, sh) for (p, leaf), sh in zip(pairs, shs)])


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
