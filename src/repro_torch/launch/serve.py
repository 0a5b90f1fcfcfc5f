"""Batched serving: prefill + decode loop with KV and recurrent-state caches.

The PyTorch counterpart of the JAX package's ``src/repro/launch/serve.py``.
A request queue is drained in fixed-size batches; each batch is prefilled in
parallel (attention in the hand-written flash-attention kernel) and decoded
token by token with greedy sampling over the family's caches (KV,
compressed MLA latents, recurrent state, cross-attention K/V). Runs every
family: dense (qwen3-0.6b, gemma2-9b/27b, mistral-nemo-12b), MoE
(deepseek-moe-16b, deepseek-v3-671b), vlm (paligemma-3b), audio
(whisper-small), SSM (xlstm-125m) and hybrid (hymba-1.5b), full size or
``--reduced``, on the GPU unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
      --reduced --device cpu --requests 16 --batch 4 --prompt-len 32 --gen 16

As in the reference, a vlm prefill is text only and its decode positions
count the image prefix too, so with the default cache length every decode
step writes the cache's last slot (the write's start is clamped); an audio
prefill encodes zero frames.

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


def prefill_batch(cfg, tokens: torch.Tensor):
    """What ``serve_batch`` prefills for ``tokens`` [b, s]: the tokens, and
    for the audio family zero frames [b, frontend_len, d_model] in f32
    beside them."""
    if cfg.family != "audio":
        return tokens
    frames = torch.zeros((tokens.shape[0], cfg.frontend_len, cfg.d_model),
                         dtype=torch.float32, device=tokens.device)
    return {"frames": frames, "tokens": tokens}


def decode_start(cfg, prompt_len: int) -> int:
    """The position of the first decode step after a prompt of
    ``prompt_len``: after the prompt, any meta tokens and, for the vlm
    family, the image prefix (which its text-only prefill leaves out)."""
    return prompt_len + cfg.num_meta_tokens + (cfg.frontend_len if cfg.family == "vlm" else 0)


def serve_batch(spec, params, prompts: np.ndarray, gen: int, cache_len: int) -> np.ndarray:
    """Prefill ``prompts`` [b, s] and greedily decode ``gen`` tokens from
    :func:`decode_start`; returns them as [b, gen] int64 on the host."""
    cfg = spec.cfg
    base = decode_start(cfg, prompts.shape[1])
    device = params["embed"].device
    tokens = torch.as_tensor(prompts, device=device)
    logits, caches = spec.prefill(params, prefill_batch(cfg, tokens), cache_len)
    tok = logits.argmax(-1)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, caches = spec.decode_step(params, tok, caches, base + i)
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
