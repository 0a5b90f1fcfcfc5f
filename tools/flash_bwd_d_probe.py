#!/usr/bin/env python3
"""How far the flash backward's dq lies from an exact gradient on a layer
whose keys share a large mean, and which way of taking each row's D keeps it.

    PYTHONPATH=src python tools/flash_bwd_d_probe.py

Needs a CUDA GPU. Captures the q, k, v and d out of whisper-small's first
and last decoder layers in one bf16 training step of 4 x 448 (random
weights and frames from seed 0, as ``chip_smoke.py`` phase 16 does), then
prints one JSON line per layer: the keys' shared mean over their spread
(``key_mean_over_spread``), and for each way of computing the gradient its
dq, dk and dv error against an f64 autograd of the same attention on the
same bf16 inputs, each as max |error| over max |g|:

- ``kernel``: the model's path, ``flash_attention_padded`` under autograd
  (the CUDA forward and backward kernels);
- ``plain``: ``flash_attention_backward_torch`` (f32; D = sum_j P dP);
- ``autograd_plain``: autograd through ``flash_attention_torch``;
- ``d_from_output``: dq as FlashAttention-2 takes it, D = dO . o with o
  the 16-bit output, the rest exact (dense, f32);
- ``ds_rounded``: dq with the exact D and dS rounded to the input type,
  without and with the tensor-core epilogue's correction (dq_i less the
  rounded dS's row sum times k_i).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_backward_torch, flash_attention_padded, flash_attention_torch,
)


def dense(q, k, v, scale):
    """(p, k, v) of causal attention in f64, k and v repeated over the group."""
    group = q.shape[1] // k.shape[1]
    kf, vf = (t.double().repeat_interleave(group, dim=1) for t in (k, v))
    s = q.double() @ kf.transpose(-1, -2) * scale
    ok = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).tril()
    return torch.softmax(torch.where(ok, s, -torch.inf), dim=-1), kf, vf


def exact(q, k, v, do, scale):
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    p, kf, vf = dense(*leaves, scale)
    return torch.autograd.grad(p @ vf, leaves, do.double())


def dq_with(q, k, v, do, scale, delta, round_to=None, correct=False):
    """scale * sum_j dS_ij k_j with dS = P (dP - delta), optionally rounded."""
    p, kf, vf = dense(q, k, v, scale)
    ds = p * (do.double() @ vf.transpose(-1, -2) - delta)
    if round_to is not None:
        ds = ds.to(round_to).double()
    dq = ds @ kf
    if correct:
        dq = dq - ds.sum(-1, keepdim=True) * kf
    return dq * scale


def rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_d_probe: needs a CUDA GPU", file=sys.stderr)
        return 1
    for name in ("flash_attention", "flash_attention_bwd"):
        _build.build(name)
    for label, q, k, v, do, kw in cs.training_activations(cs.WH_ARCH, cs.TRAIN_BATCH,
                                                          cs.WH_TRAIN_SEQ):
        scale = kw["sm_scale"]
        want = exact(q, k, v, do, scale)
        kk = k.double()
        mean = kk.mean(dim=2, keepdim=True)
        p, _, vf = dense(q, k, v, scale)
        o16 = (p @ vf).to(q.dtype).double()
        d_exact = ((p @ vf) * do.double()).sum(-1, keepdim=True)
        _, lse = flash_attention_torch(q, k, v, sm_scale=scale, return_lse=True)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        kernel = torch.autograd.grad(flash_attention_padded(*leaves, sm_scale=scale),
                                     leaves, do)
        auto = torch.autograd.grad(flash_attention_torch(*leaves, sm_scale=scale), leaves, do)
        row = {
            "layer": label,
            "key_mean_over_spread": float(mean.norm(dim=-1).mean()
                                          / (kk - mean).norm(dim=-1).mean()),
            "kernel": [rel(g, w) for g, w in zip(kernel, want)],
            "plain": [rel(g, w) for g, w in zip(
                flash_attention_backward_torch(q, k, v, lse, do, sm_scale=scale), want)],
            "autograd_plain": [rel(g, w) for g, w in zip(auto, want)],
            "d_from_output": rel(dq_with(q, k, v, do, scale,
                                         (o16 * do.double()).sum(-1, keepdim=True)), want[0]),
            "ds_rounded": rel(dq_with(q, k, v, do, scale, d_exact, q.dtype), want[0]),
            "ds_rounded_corrected": rel(dq_with(q, k, v, do, scale, d_exact, q.dtype, True),
                                        want[0]),
        }
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
