#!/usr/bin/env python3
"""Time the flash backward at one shape, in turns with the backward of
``scaled_dot_product_attention``.

    python3 tools/flash_bwd_bench.py [--src DIR] [--shape B,HQ,HKV,S,D]
        [--window W] [--softcap C] [--runs N] [--inner N] [--label TEXT]

Needs a CUDA GPU and the CUDA toolkit. ``--src`` is the directory that
holds the ``repro_torch`` package (default: this checkout's ``src/``), so
that two trees can be timed on one card in one session, e.g. a parent
commit unpacked with ``git archive`` beside the working tree: run parent,
change, change, parent. Each run builds (or finds) the backward library of
its own tree.

Inputs are bf16 from seeded ``torch.randn``, causal, ``sm_scale`` D^-0.5.
Each timing is a median of ``--runs`` CUDA-event timings of ``--inner``
launches back to back, after one warm-up; the kernel and SDPA's backward
(through autograd, no window or softcap: no PyTorch call takes a softcap)
are timed in turns, twice each. Prints one JSON line: the card's name and
power limit, which backward ran (``tensor_cores``), the kernel's and SDPA's
times, and the bound: the backward's five products
(``flash_attention_flops(..., backward=True)``) over the bf16 tensor-core
peak of an H100 SXM, 989 TFLOP/s.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

BF16_TENSOR_OPS_PER_S = 989e12


def time_ms(torch, fn, runs: int, inner: int) -> float:
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--shape", default="1,16,8,8192,256")
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--softcap", type=float, default=None)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--inner", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_flops, flash_attention_lse,
    )

    if not torch.cuda.is_available():
        print("flash_bwd_bench: needs a CUDA GPU", file=sys.stderr)
        return 1
    b, hq, hkv, s_len, d = (int(x) for x in args.shape.split(","))
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for shape in ((b, hq, s_len, d), (b, hkv, s_len, d), (b, hkv, s_len, d),
                                 (b, hq, s_len, d)))
    kw = dict(sm_scale=d ** -0.5, window=args.window, softcap=args.softcap)
    _, lse = flash_attention_lse(q, k, v, **kw)
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    tc_before = flash_attention.tensor_core_backward_launches
    kernel_ms, sdpa_ms = [], []
    for _ in range(2):
        kernel_ms.append(time_ms(torch, lambda: flash_attention_backward(q, k, v, lse, do, **kw),
                                 args.runs, args.inner))
        sdpa_ms.append(time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (ql, kl, vl), do, retain_graph=True), args.runs, args.inner))
    tensor_cores = flash_attention.tensor_core_backward_launches > tc_before
    flops = flash_attention_flops(b, hq, s_len, d, window=args.window, backward=True)
    bound_ms = flops / BF16_TENSOR_OPS_PER_S * 1e3
    ms = statistics.median(kernel_ms)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(json.dumps({
        "label": args.label, "src": args.src, "card": smi, "shape": [b, hq, hkv, s_len, d],
        "window": args.window, "softcap": args.softcap, "tensor_cores": tensor_cores,
        "kernel_ms": kernel_ms, "ms": ms, "sdpa_ms": sdpa_ms,
        "sdpa_median_ms": statistics.median(sdpa_ms), "flops": flops, "bound_ms": bound_ms,
        "share_of_bound": bound_ms / ms,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
