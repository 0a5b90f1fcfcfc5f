"""Input pipelines.

The PyTorch counterpart of the JAX package's ``src/repro/data/pipeline.py``.
Two sources behind one interface:

  * SyntheticLM — deterministic stateless token stream (seed, step) -> batch;
    restart-safe by construction (resuming at step k regenerates batch k), so
    checkpoint/restart needs no data-state snapshotting.
  * MemmapLM — file-backed token corpus (np.memmap), strided per step, for
    the train examples.

Host batches come from numpy exactly as the reference makes them, so they
are bit-identical to its batches; ``batch_at`` places them on a device, or,
given shardings (``sharding.batch_shardings``), as DTensors: each rank
builds the global batch from the same seed and keeps its shard.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.api import ArchConfig


def _on(host: dict[str, np.ndarray], device, shardings=None) -> dict:
    """The host batch on ``device``, or placed under ``shardings`` (one
    NamedSharding, or a dict of them by key) on its mesh's device."""
    if shardings is None:
        return {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    from ..sharding.spmd import mesh_device, place

    out = {}
    for k, v in host.items():
        sh = shardings[k] if isinstance(shardings, dict) else shardings
        out[k] = place(torch.as_tensor(v, device=mesh_device(sh.mesh)), sh)
    return out


@dataclass
class SyntheticLM:
    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, step))

    def host_batch(self, step: int) -> dict[str, np.ndarray]:
        rng = self._rng(step)
        # structured stream: Zipfian unigram + local repetition, so the loss
        # curve has learnable signal (not pure noise)
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = (z % (self.cfg.vocab - 2)).astype(np.int32) + 1
        rep = rng.random((self.batch, self.seq + 1)) < 0.3
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        out = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.cfg.frontend == "audio":
            out["frames"] = rng.standard_normal(
                (self.batch, self.cfg.frontend_len, self.cfg.d_model), np.float32
            ) * 0.1
        elif self.cfg.frontend == "vision":
            out["prefix_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.frontend_len, self.cfg.d_model), np.float32
            ) * 0.1
        return out

    def batch_at(self, step: int, device="cuda", shardings=None) -> dict:
        return _on(self.host_batch(step), device, shardings)


@dataclass
class MemmapLM:
    """Token file pipeline: flat int32 tokens, strided deterministic batches."""

    path: str
    cfg: ArchConfig
    batch: int
    seq: int

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        self._tokens_per_step = self.batch * (self.seq + 1)

    @property
    def num_steps(self) -> int:
        return len(self._data) // self._tokens_per_step

    def host_batch(self, step: int) -> dict[str, np.ndarray]:
        off = (step % self.num_steps) * self._tokens_per_step
        chunk = np.asarray(self._data[off : off + self._tokens_per_step])
        chunk = chunk.reshape(self.batch, self.seq + 1) % self.cfg.vocab
        return {"tokens": chunk[:, :-1], "labels": chunk[:, 1:].astype(np.int32)}

    def batch_at(self, step: int, device="cuda", shardings=None) -> dict:
        return _on(self.host_batch(step), device, shardings)
