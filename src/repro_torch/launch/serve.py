"""Batched serving: prefill + decode loop with KV caches.

The PyTorch counterpart of the JAX package's ``src/repro/launch/serve.py``.
A request queue is drained in fixed-size batches; each batch is prefilled in
parallel (attention in the hand-written flash-attention kernel) and decoded
token by token with greedy sampling over the layers' KV caches. Runs the
dense family (qwen3-0.6b, gemma2-9b/27b, mistral-nemo-12b), full size or
``--reduced``, on the GPU unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --reduced --device cpu --requests 16 --batch 4 --prompt-len 32 --gen 16

Weights are random, from a ``torch.Generator`` seeded by ``--seed``.

``--premap-kernels SIZE`` warms the node before serving: the CGRA kernel
suite is batch-compiled onto a SIZE×SIZE grid through the compiler API
(``repro_torch.api.Compiler.compile_batch``, "fast" profile), against the
persistent mapping cache (``--cache-dir`` / ``$REPRO_CACHE_DIR``). A warm
restart then boots without re-solving a single mapping (DESIGN.md §8). The
premap runs first in ``main``, before anything touches CUDA, so the
compile pool forks from a process without a CUDA context.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..kernels.ops import resolve_device
from ..models import build_model


def serve_batch(spec, params, prompts: np.ndarray, gen: int, cache_len: int) -> np.ndarray:
    """Prefill ``prompts`` [b, s] and greedily decode ``gen`` tokens;
    returns them as [b, gen] int64 on the host."""
    s = prompts.shape[1]
    device = params["embed"].device
    logits, caches = spec.prefill(params, torch.as_tensor(prompts, device=device),
                                  cache_len)
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, caches = spec.decode_step(params, tok, caches, s + i)
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1).cpu().numpy()


def premap_kernels(size: int, jobs: int, cache_dir: str | None) -> None:
    """Boot-time warm-up: batch-map the kernel suite via the compiler API."""
    from ..api import Compiler, resolve_options
    from ..core.benchsuite import load_suite
    from ..core.cgra import CGRA

    compiler = Compiler(
        CGRA(size, size),
        resolve_options("fast", jobs=jobs, deadline_s=30.0,
                        cache_dir=cache_dir),
    )
    batch = compiler.compile_batch(list(load_suite().values()))
    c = batch.cache_counters
    print(
        f"premap: {len(batch)} kernels on {compiler.cgra} in "
        f"{batch.wall_s:.2f}s ({batch.num_workers} workers) — "
        f"{c['solved']} solved, {c['memory_hits'] + c['disk_hits']} cache "
        f"hits, {c['failed']} failed"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument(
        "--premap-kernels", type=int, default=0, metavar="SIZE",
        help="before serving, batch-compile the CGRA kernel suite onto a "
             "SIZE×SIZE grid (0 = skip)",
    )
    ap.add_argument("--premap-jobs", type=int, default=2)
    ap.add_argument(
        "--cache-dir", default=None,
        help="persistent mapping cache for --premap-kernels "
             "(default: $REPRO_CACHE_DIR)",
    )
    args = ap.parse_args(argv)

    if args.premap_kernels:
        premap_kernels(args.premap_kernels, args.premap_jobs, args.cache_dir)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    spec = build_model(cfg)
    params = spec.init(args.seed, device)

    rng = np.random.default_rng(args.seed)
    queue = [
        rng.integers(1, cfg.vocab, size=args.prompt_len).astype(np.int64)
        for _ in range(args.requests)
    ]
    cache_len = args.prompt_len + args.gen + 8

    t0 = time.perf_counter()
    done = 0
    while queue:
        batch = queue[: args.batch]
        queue = queue[args.batch :]
        prompts = np.stack(
            batch + [batch[-1]] * (args.batch - len(batch))
        )  # pad the tail batch
        tokens = serve_batch(spec, params, prompts, args.gen, cache_len)
        done += len(batch)
        print(f"batch done: {len(batch)} reqs, sample continuation {tokens[0][:8]}")
    dt = time.perf_counter() - t0
    total_tokens = done * args.gen
    print(f"served {done} requests / {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
