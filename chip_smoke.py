#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and the CUDA
toolkit (``nvcc``); it builds the port's CUDA kernels into ``build/`` first.
It drives the port's paths through the entry points a user calls — map
a loop with the port's mapper (directly, through the compiler API or through
the compile daemon), lower it and execute it batched through the
hand-written ``cgra_sim`` kernel; serve qwen3-0.6b at full width with its
prefill attention in the hand-written ``flash_attention`` kernel; train
qwen3-0.6b at full width with attention's forward and gradient in the
hand-written ``flash_attention`` and ``flash_attention_bwd`` kernels; serve
deepseek-moe-16b at full width and depth (MoE layers) through the flash
kernel, train a 4-layer cut of it, and serve a 4-layer cut of
deepseek-v3-671b (MLA); serve and train hymba-1.5b (windowed GQA-5
attention in the flash kernels beside SSD heads) and xlstm-125m (mLSTM,
sLSTM) at full width and depth; serve and train paligemma-3b (its text
prefill's MQA attention at D 256 in the flash kernel, prefix-LM training on
the scores path) and whisper-small (its decoder's self-attention in the
flash kernels, the encoder and cross-attention on the scores path) at full
width and depth; train qwen3-0.6b sharded on torch.distributed meshes and
deepseek-moe-16b's cut expert-parallel, several ranks on the one card;
serve qwen3-0.6b sharded, run the dry-run and hold a training step
against its roofline; serve gemma2-9b at full width and depth (softcapped,
alternately windowed GQA attention at D 256 in the flash kernel) and train
a 4-layer cut of it through the D 256 tensor-core backward — and
fails (non-zero exit, no result line) if any phase fails:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles ``src/repro_torch/kernels/csrc/cgra_sim.cu``,
   ``flash_attention.cu`` and ``flash_attention_bwd.cu`` with nvcc, one
   process each, in parallel;
3. small programs: the cgra_sim kernel's trace equals the plain PyTorch
   version on the card (``torch.equal``) and the numpy oracle, and its store
   streams match the scalar interpreter on lane 0;
4. CGRA path at full size: hotspot3D, backprop and aes mapped on a 20x20
   grid and run over 16384 streams x 64 iterations; kernel launches are
   counted over this phase alone. Each trace equals the plain version on
   the card, and 8 sampled lanes equal the oracle exactly;
5. timing of cgra_sim (zero-fill of the trace included) and its plain
   version, with CUDA events, beside the least time the card could take;
6. the flash kernels against their plain version on every shape and option
   of the JAX package's flash sweep in f32 (CUDA-core kernel) and in bf16
   (tensor-core kernel), plus D = 192 and 256, f16, S below one tile, all
   rows masked, a ragged S through the padding path, hymba-1.5b's prefill
   at batch 1 (25 q / 5 kv heads: GQA group 5, D 64, S 2176) with window
   1024 and without, in bf16 and f32, and the serve shape (2e-5 in f32,
   2e-2 in bf16/f16); each case checks which kernel ran;
7. serving path at full width: qwen3-0.6b (28 layers, d 1024, 16/8 heads,
   head_dim 128, vocab 151936, bf16, seeded random weights) serves 8
   requests in batches of 4, prompt 2048, 32 generated tokens; flash
   launches, and those of the tensor-core kernel, are counted over this
   phase alone (each >= 28 per batch). Prefill and decode are timed and
   profiled (torch.profiler). The kernel is held against its plain version
   on the q/k/v that layers 0 and 27 produce in a bf16 prefill. In f32, one
   batch's prefill and teacher-forced decode logits match the same path
   with the plain attention version;
8. timing of the flash kernel at the serve shape in turns with
   ``scaled_dot_product_attention`` (a yardstick only; the port never calls
   it), beside its bound and its plain version, and of the CUDA-core kernel
   on the same shape in f32;
9. the flash backward kernels against their plain version
   (``flash_attention_backward_torch``, fed the same q, k, v, output,
   log-sum-exp and d out) and against autograd through
   ``flash_attention_torch``, on every case of phase 6 (the padded one
   through autograd of ``flash_attention_padded``; hymba's GQA-5 shape
   with window 1024 and global, bf16 and f32, among them), bf16 and f16
   at D 64, 128 and 256 with GQA groups 1, 2 and 4, window, softcap, S
   below one tile and a ragged S, the training shape, the tensor-core
   forward and backward as the first CUDA work of a fresh host thread (the
   same bits as on the main thread), and the q, k, v and d out that
   layers 0 and 27 see in one bf16 training step of phase 10's model;
   within 2e-5 (f32) / 2e-2 (bf16, f16) of each gradient's max |g|; the
   forward's log-sum-exp against the plain one; each case checks which
   backward ran (tensor cores for bf16/f16 at D 64, 128 and 256, CUDA
   cores otherwise), that the autograd Function gives the same gradients
   and that the tensor-core backward gives the same bits twice. Then
   gemma2-27b's layer (D 128, 32 q / 16 kv heads, scale 144^-0.5) and
   gemma2-9b's (D 256, 16 / 8, 256^-0.5), softcap 50 and window 4096 on
   4352 positions, with queries and keys that share a mean 16 and 32 times
   their spread: every gradient of the tensor-core backward within 1e-2 of
   its max |g| of the plain version in f32 (the softcapped dq's epilogue
   takes out dS's rounding errors);
10. training path at full width: qwen3-0.6b (bf16, remat) trains 8 steps
   of batch 4 x 2048 through ``launch.train``'s ``make_state`` /
   ``make_step`` and ``runtime.run_training`` (AdamW at the CLI's
   defaults, a fresh checkpoint directory under ``build/``), then 2 steps
   with gradient compression. No restart, finite losses, the first near
   ln(vocab), >= 28 forward, tensor-core forward, backward and tensor-core
   backward launches per step (counted over this phase alone), and the
   saved checkpoint restores bit for bit. Reports ms/step, tokens/s, peak
   memory, the save's time and a profile of one step. Then one f32 step at
   batch 1 x 2048 through the kernels (the CUDA-core backward) against the
   same step with the plain attention versions: loss within 1e-5 (of
   max(1, |loss|)), each gradient leaf within 1e-3 of its max |g|;
11. timing of the tensor-core backward at the training shape in turns with
   the backward of ``scaled_dot_product_attention`` (a yardstick only),
   beside its bound, its plain version and the CUDA-core backward on the
   same shape in f32.
12. compiler API path at full size, through the entry points users call:
   the 17-kernel suite premapped cold onto a 20x20 grid by ``python -m
   repro_torch.compile`` (a subprocess with no CUDA context, 4 forked
   workers, a fresh persistent cache under ``build/``); a warm
   ``repro_torch.api.Compiler`` session on the same cache (17 disk hits, 0
   solves, the mappings the cold run wrote); every warm mapping executed by
   ``cgra_run`` at 16384 streams x 64 iterations; heartwall and backprop
   mapped on the ``mesh_50x50`` preset by the annealing engine and executed
   at the same size (traces of 43 and 53 GB, checked against the plain
   version in lane chunks), heartwall's kernel timed beside its bound; the
   suite on the heterogeneous ``satmapit_edge_mem_4x4`` preset mapped and
   executed; ``examples/quickstart_torch.py`` run on the card. cgra_sim
   launches are counted over the phase's executions alone.
13. compile daemon, tracing frontend, fuzz generator and stage placement:
   ``python -m repro_torch.daemon serve`` (a subprocess, 4 workers, time
   backend ``auto``: z3 where it is importable, its cold solves in the
   daemon's worker processes, a 90 s budget; 20x20, fast profile, a fresh
   cache and trace directory under ``build/``,
   the socket in a short temporary directory) answers ping, then the suite
   from 26 client threads at once (hotspot3D, backprop and aes from 4 each):
   every row ok, every request accounted for by solves, warm hits and
   coalescing, no kernel solved twice, a clean shutdown and rotated trace
   segments that ``tools/trace_report.py`` reads, all on z3 where z3 is
   importable and the cold wall under the 93.66 s z3 takes for the suite
   alone; a warm
   ``repro_torch.api.Compiler`` on the daemon's cache (17 disk hits, the
   daemon's IIs), each mapping executed at 16384 x 64 as in phase 12. Three
   loops traced by ``repro_torch.core.frontend.trace_loop`` (a
   multiply-accumulate, whose stores equal a numpy running sum, a mixed-op
   body and one with every overloaded operator) mapped on 20x20 and executed
   at the same size. ``random_dfg`` seeds 0-101 on ``tests/
   test_differential.py``'s three fabrics, mapped deterministically by the
   exact engine and executed at 4096 x 32: each trace equals the plain
   version and 8 lanes the oracle. ``examples/pipeline_placement_torch.py``.
   cgra_sim launches are counted over the phase alone.
14. the DeepSeek family (MoE layers, MLA, multi-token prediction):
   deepseek-moe-16b at full width and depth (28 layers: 1 dense, 27 MoE of
   64 routed experts, top-6 softmax, 2 shared; d 2048, 16/16 heads, head
   dim 128, vocab 102400, bf16, seeded random weights, 16.4 B parameters)
   serves 8 requests in batches of 4 (prompt 2048, 32 tokens) through
   ``serve_batch``: >= 28 flash launches a batch, all on the tensor-core
   forward (GQA group 1), counted over the serving run alone; two prefills
   of one batch give identical logits; the kernel against its plain
   version on layers 0 and 27's prefill q/k/v (2e-2), and timed at that
   shape in turns with ``scaled_dot_product_attention``. In f32 at 2
   layers (1 dense + 1 MoE), prefill and 8 teacher-forced decode steps
   through the kernel path match the plain-attention path (1e-4), with
   the routing-flip rule: a row is compared where its token's top-k
   experts and kept assignments agree in every MoE layer, and a differing
   top-k set must be a near-tie (k-th and (k+1)-th scores within 1e-5).
   4 training steps at 4 layers (1 dense + 3 MoE), 4 x 2048, bf16, remat,
   through make_state / make_step / run_training: finite losses, aux > 0
   and inside the loss, >= 4 flash forward and tensor-core backward
   launches a step. deepseek-v3-671b at full width, 4 layers (3 dense + 1
   MoE of 256 experts, MLA, sigmoid routing, MTP) serves 4 requests
   (prompt 2048, 16 tokens) in bf16; in f32 at batch 1, the first MoE
   router's input at each position and the logits of prefill and 15
   teacher-forced decode steps match one parallel forward (2e-3), with
   the same rule (positions whose capacity drops differ are counted, not
   compared).
15. the SSM and hybrid families: hymba-1.5b at full width and depth (32
   layers, d 1600, 25 q / 5 kv heads of D 64, SSD state 16, 128 meta
   tokens, window 1024 except on layers 0, 16 and 31, vocab 32001, bf16,
   seeded random weights, 1.351 B parameters) serves 8 requests in batches
   of 4 (prompt 2048, 32 tokens) through ``serve_batch``: exactly 32 flash
   launches a prefill, all on the tensor-core forward, two prefills
   identical; the kernel against its plain version on layers 0, 1
   (windowed) and 31's prefill q/k/v; prefill and decode timed and
   profiled. The flash forward at its two prefill shapes (B 4, window 1024
   and global) timed beside its bound, and scaled_dot_product_attention at
   the global one. In f32 at batch 1 x 2048, the prefill logits of the
   kernel path against the plain-attention path, and a prefill plus one
   decode step against a prefill one token longer (1e-4: the SSD state and
   the offset KV cache carry). 2 training steps of 4 x 2048 (bf16, remat,
   AdamW, make_state / make_step): finite losses, 64 tensor-core forward
   launches (pass and recompute) and 32 tensor-core backward launches a
   step; a third step profiled. Then xlstm-125m (12 layers, d 768, 4
   heads, mLSTM / sLSTM alternating, vocab 50304, 112.7 M parameters) the
   same way without attention at prompt 1024: served, timed and its
   decode profiled at full depth, 2 training steps of a 2-layer cut (one
   mLSTM, one sLSTM; its step is host-bound: one launch per op of the
   recurrence). Its f32 state carry: within 1e-4 after a 32-token prompt, and
   after the 2048-token prompt within 10x of the rounding floor (the same
   prefill with every embedding moved by one ulp), since its random-weight
   recurrence amplifies f32 rounding ~1e5-fold over 2048 steps.
16. the vision-language and audio families: paligemma-3b at full width
   and depth (18 layers, d 2048, 8 q / 1 kv heads of D 256, GeGLU d_ff
   16384, vocab 257216, tied and scaled embeddings, prefix-LM over 256
   prefix embeddings, bf16, seeded random weights, 2.509 B parameters)
   serves 8 requests in batches of 4 (prompt 2048, 32 tokens) through
   ``serve_batch``: the prefill is text only, as the reference's, so
   exactly 18 flash launches a prefill, all on the tensor-core forward at
   GQA group 8 and D 256; decode runs at the reference's positions past the
   image prefix, past the end of the cache, each write clamped into its
   last slot; two prefills identical; the kernel against its plain version
   on layers 0 and 17's prefill q/k/v (2e-2); prefill and decode timed and
   profiled; the flash forward timed at (4, 8, 1, 2048, 256) beside its
   bound and scaled_dot_product_attention. In f32 at 2 layers and batch 1
   x 2048, prefill and 8 teacher-forced decode steps through the kernel
   path against the plain-attention path (1e-4). 2 training steps of 2 x
   2048 tokens + 256 prefix embeddings (bf16, remat, AdamW, make_state /
   make_step): finite losses, no flash launch (prefix-LM attends on the
   scores path), peak memory logged. Then whisper-small at full width and
   depth (12 encoder + 12 decoder layers, d 768, 12 / 12 heads of D 64,
   d_ff 3072, vocab 51865, 1500 frames, bf16, 263.3 M parameters) serves 8
   requests in batches of 4 with zero frames, as the reference does
   (prompt 224, 32 tokens): exactly 12 tensor-core flash launches a
   prefill (the decoder's self-attention, 224 rows padded to 256), two
   prefills identical, layers 0 and 11's q/k/v against the plain version,
   timed and profiled, the kernel timed at (4, 12, 12, 256, 64); in f32 at
   batch 1 with random frames, prefill and 8 teacher-forced decode steps
   against the plain-attention path (1e-4); 2 training steps of 4 x 448
   tokens with 1500 random frames: finite losses, 24 tensor-core forward
   (pass and recompute) and 12 tensor-core backward launches a step; then
   decoder layers 0 and 11's q, k, v and d out, captured in one such bf16
   step (448 rows, padded to 512), hold the forward (2e-2) and, through
   the padded path under autograd, the tensor-core backward against their
   plain versions (as phase 9 holds qwen3-0.6b's training layers).
17. sharded training on torch.distributed (``sharding/``, ``launch/mesh.py``,
   ``make_sharded_state`` / ``make_sharded_step``): (a) this process alone
   over NCCL on a 1x1 mesh from ``make_debug_mesh``, qwen3-0.6b at full
   width (bf16, remat) under the rules' shardings takes 2 steps of 4 x 2048
   from phase 10's state and batches; its losses and updated parameters
   equal ``make_step``'s (else within 2e-2 of max |x|, said so), >= 28
   tensor-core flash forward and backward launches a step. (b) several
   ranks on the one card over gloo with CUDA tensors (this script run as
   ``--sharded-rank`` processes, NCCL taking one rank per card): qwen3-0.6b
   on a 2x2 ("data", "model") mesh, global batch 4 x 2048, its attention on
   each rank's 8 q / 4 kv heads, 2 steps; then deepseek-moe-16b's 4-layer
   cut on a 1x2 mesh (experts over "model"; batch 2 x 2048, the data axis
   of size 1, so the capacity drops are the one-rank run's), 2 steps. Each
   rank's global losses and grad norms within 2e-2 of the one-rank run's,
   the update of each of its parameter shards (final minus initial) within
   SH_UPDATE_TOL of the one-rank run's update of the same slice in norm
   (||d - d_1|| / ||d_1||: a shard left unchanged reads 1), its flash
   launches >= the layers a step, all tensor-core; step times and peak
   memory per rank.
18. sharded serving, the dry-run and the roofline (``build_model(cfg,
   mesh=...)``'s ``prefill`` / ``decode_step``, ``launch/dryrun.py``,
   ``roofline/``): (a) phase 7's requests (qwen3-0.6b, 8 in batches of 4,
   prompt 2048, 32 tokens) served by the sharded spec on a 1x1 mesh over
   NCCL through ``serve_batch``: tokens and teacher-forced logits
   bit-equal to the unsharded spec's, >= 28 tensor-core flash launches a
   prefill; then 4 ranks on 2x2 over gloo on the one card
   (``--sharded-rank``) with caches of 16384 slots, so that each layer's
   cache lies as the reference places the stacked one (L 28 over "data",
   the slots over "model": each rank holds 14 layers' 8192 slots, checked):
   in f32 at 2 layers, the prefill's and 8 teacher-forced decode steps'
   logits within 1e-4 of max |logit| of the one-rank run; at full depth in
   bf16 the first batch of requests served greedily (each 2x2 decode step
   is some 280 gloo collectives through the host), printed beside the
   one-rank run's tokens with the first step where they part and the
   logit gap there;
   >= 28 tensor-core flash launches a prefill on every rank. (b) ``python
   -m repro_torch.launch.dryrun`` in subprocesses with no card visible,
   started with the phase: qwen3-0.6b train_4k on 16x16 and 2x16x16,
   deepseek-v3-671b decode_32k on 2x16x16; each ``ok`` with FLOPs > 0 and
   a useful-FLOP ratio in (0, 1], its row printed. (c) phase 10's step
   (make_step, 4 x 2048, bf16, remat) counted by the dry-run on a 1x1
   fake mesh and run 5 times on the card: the median of steps 2-5 must
   not beat the count's roofline bound, and the predicted peak must be
   within 0.7-1.3x of the card's over the state's start; the bound over
   the measured time is the whole step's roofline share.
19. gemma2-9b at full width and depth (42 layers, d 3584, 16 q / 8 kv
   heads of D 256, GeGLU d_ff 14336, vocab 256000, sandwich norms, tied and
   scaled embeddings, attention softcap 50, final softcap 30, window 4096
   on the even layers, bf16, seeded random weights, 9.242 B parameters)
   serves 8 requests in batches of 4 (prompt 6144, longer than the window,
   32 tokens) through ``serve_batch``: exactly 42 flash launches a
   prefill, all on the tensor-core forward at D 256 and GQA group 2, each
   layer's call with its window and the softcap; two prefills identical;
   the kernel against its plain version on layers 0 (local), 1 (global)
   and 41's prefill q/k/v (2e-2); prefill and decode timed and profiled;
   the flash forward timed at (4, 16, 8, 6144, 256) beside its bound and
   scaled_dot_product_attention, and with window 4096. In f32 at 2 layers
   (1 local + 1 global) and batch 1 x 6144, prefill and 8 teacher-forced
   decode steps through the kernel path against the plain-attention path
   (1e-4). 3 training steps of a 4-layer cut (2 local, 2 global) at full
   width, 1 x 8192 tokens (bf16, remat, AdamW, make_state / make_step):
   finite losses, 8 tensor-core forward and 4 tensor-core backward
   launches a step, one step profiled, peak memory beside the dry-run's
   prediction; the forward (2e-2) and the D 256 tensor-core backward (2e-2
   of each max |g|, the same bits twice) against their plain versions on
   the q, k, v and d out of the cut's layers 0 and 1 in one such step; the
   backward timed at (1, 16, 8, 8192, 256) beside its bound and the
   backward of scaled_dot_product_attention, and with window 4096 and
   softcap 50.

The line before the last is ``{"kernels": [...]}``, one entry per kernel;
the last is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import Compiler, resolve_options  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import CGRA, DFG, Edge, map_dfg, op_class, running_example  # noqa: E402
from repro_torch.core.benchsuite import load_suite  # noqa: E402
from repro_torch.core.daemon import DaemonClient, DaemonError  # noqa: E402
from repro_torch.core.frontend import trace_loop  # noqa: E402
from repro_torch.core.fuzz import random_dfg  # noqa: E402
from repro_torch.core.dfg import OP_ARITY  # noqa: E402
from repro_torch.core.mapper import clear_mapping_cache  # noqa: E402
from repro_torch.core.simulate import check_equivalence, interpret_dfg  # noqa: E402
from repro_torch.core.time_backends import available_backends  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cgra_sim import cgra_sim, cgra_sim_torch  # noqa: E402
from repro_torch.checkpoint import restore  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_backward, flash_attention_backward_torch,
    flash_attention_flops, flash_attention_lse, flash_attention_padded, flash_attention_torch,
)
from repro_torch.kernels.ops import cgra_run, compile_program  # noqa: E402
from repro_torch.kernels.ref import cgra_sim_reference  # noqa: E402
from repro_torch.launch.serve import decode_start, prefill_batch, serve_batch  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.train import (  # noqa: E402
    make_sharded_state, make_sharded_step, make_state, make_step,
)
from repro_torch.models import attention, build_model, moe  # noqa: E402
from repro_torch.models import build as lm  # noqa: E402
from repro_torch.optim import AdamWConfig, build_opt_shardings  # noqa: E402
from repro_torch.runtime import FaultConfig, run_training  # noqa: E402
from repro_torch.sharding import P, batch_shardings, param_shardings  # noqa: E402
from repro_torch.sharding.spmd import (  # noqa: E402
    Spmd, full_tensor, mesh_device, place, reshard, spec_of,
)
from repro_torch.tree import leaves, leaves_with_paths, unflatten  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 rate
# outside the tensor cores and the dense bf16 tensor-core rate, at the full
# 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12

FULL_GRID = (20, 20)
FULL_BATCH = 16384
FULL_ITERS = 64
FULL_KERNELS = ("hotspot3D", "backprop", "aes")
SAMPLED_LANES = 8
TIMED_RUNS = 10
FLASH_INNER = 10      # flash launches per timing (see time_ms)

KERNELS = ("cgra_sim", "flash_attention", "flash_attention_bwd")

SERVE_ARCH = "qwen3-0.6b"
SERVE_REQUESTS = 8
SERVE_BATCH = 4
SERVE_PROMPT = 2048
SERVE_GEN = 32


def cache_len_for(prompt_len: int) -> int:
    """The cache length the serve CLI gives a prompt of ``prompt_len``."""
    return prompt_len + SERVE_GEN + 8


SERVE_CACHE_LEN = cache_len_for(SERVE_PROMPT)
# the serve shape of the flash kernel: qwen3-0.6b prefill of one batch
SERVE_SHAPE = (SERVE_BATCH, 16, 8, SERVE_PROMPT, 128)
# f32 logits of the kernel path against the plain-attention path. Logits are
# O(1); the two attention versions differ by ~1e-6 in f32 (sum order, FMA),
# which 28 layers may amplify by 10-100x. 1e-4 keeps that margin, while a
# wrong mask, scale or head mapping moves logits by far more.
SERVE_F32_TOL = 1e-4

TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 8
TRAIN_TIMED_FROM = 2          # ms/step: the median over steps 3..8
COMPRESSION_STEPS = 2
# the flash kernels' shape in a training step of qwen3-0.6b
TRAIN_SHAPE = (TRAIN_BATCH, 16, 8, TRAIN_SEQ, 128)
# The first loss of random weights: the final rms_norm gives hidden states
# of unit rms and the tied embedding (std 0.02) logits of std ~0.02*sqrt(d)
# = 0.64, so lse ~ ln(vocab) + 0.64^2/2 = 12.13 and the loss, with the
# z-loss (1e-4 lse^2 = 0.015), ~12.15; the band keeps +-0.25 around
# [ln(vocab), 12.15], more above, where a hidden state that keeps some of
# its token's embedding would raise the logits' spread.
FIRST_LOSS_BAND = (11.65, 12.7)
# f32 full width, kernels vs plain attention: the loss (~12) within 1e-5 of
# max(1, |loss|), each gradient leaf within 1e-3 of its max |g|
PARITY_LOSS_TOL = 1e-5
PARITY_GRAD_TOL = 1e-3
BWD_INNER = 3         # backward launches per timing at the training shape

API_GRID = 20
API_JOBS = 4
API_DEADLINE_S = 30.0
# The IIs the JAX package's own compile CLI gives for the same cold premap
# (the same flags: the suite on 20x20, fast profile, 4 workers, 30 s
# deadline; run on a CPU host): printed beside the port's, not a gate, since
# the fast profile's wall-clock budgets may settle one II higher under load.
REFERENCE_II_20 = {
    "aes": 14, "backprop": 5, "basicmath": 7, "bitcount": 3, "cfd": 6,
    "crc32": 8, "fft": 7, "gsm": 4, "heartwall": 4, "hotspot3D": 5, "lud": 4,
    "nw": 4, "particlefilter": 9, "sha1": 3, "sha2": 7, "stringsearch": 3,
    "susan": 5,
}
LARGE_PRESET = "mesh_50x50"
LARGE_KERNELS = ("heartwall", "backprop")     # heartwall: BENCH_scale.json's kernel
LANE_CHUNK = 1024      # lanes of the plain version held at once at 50x50
HETERO_PRESET = "satmapit_edge_mem_4x4"

DAEMON_WORKERS = 4
# The daemon starts as a user starts it: time backend ``auto`` (z3 where it
# is importable, as on the GPU machine; its cold solves then run in the
# daemon's worker processes), with this wall budget per request. The fast
# profile's 20 s assumes a solve has a core to itself; a cold stampede of
# 26 requests on 4 workers does not give it one.
DAEMON_BUDGET_S = 90.0
# z3 alone mapped the suite on 20x20 in 93.66 s (one worker); 4 workers
# must beat that
Z3_SUITE_ALONE_S = 93.66
# each of these goes out from DAEMON_DUP_CLIENTS clients at once, the rest
# of the suite from one client each: 26 client threads
DAEMON_DUPLICATED = ("hotspot3D", "backprop", "aes")
DAEMON_DUP_CLIENTS = 4
DAEMON_ROTATE = 8          # worker-run requests per rotated trace segment
DAEMON_START_S = 60.0      # the daemon must answer ping within this
DAEMON_REQUEST_S = 300.0   # a client's socket timeout
# the traced multiply-accumulate against a numpy running sum of a*b in f32
MAC_RTOL = 1e-5
# tests/test_differential.py's fabrics and deterministic mapper budgets;
# seeds 0-101 of the harness's 0-203 (cut to pay for phase 19's time)
FUZZ_SEEDS = 102
FUZZ_FABRICS = (("mesh3x3", dict(rows=3, cols=3)),
                ("torus4x4", dict(rows=4, cols=4, topology="torus")),
                ("onehop4x4", dict(rows=4, cols=4, topology="one-hop")))
FUZZ_MAP_KW = dict(deterministic=True, use_cache=False, det_space_cap=4000,
                   max_retries_per_window=1, max_slack=1)
FUZZ_BATCH = 4096
FUZZ_ITERS = 32

DS_ARCH = "deepseek-moe-16b"
# the flash kernel's shape at deepseek-moe-16b's prefill: MHA, GQA group 1
DS_SHAPE = (SERVE_BATCH, 16, 16, SERVE_PROMPT, 128)
DS_F32_LAYERS = 2          # 1 dense + 1 MoE, full width, f32
DS_F32_STEPS = 8           # teacher-forced decode steps
DS_TRAIN_LAYERS = 4        # 1 dense + 3 MoE, full width, bf16, remat
DS_TRAIN_BATCH = 4
DS_TRAIN_STEPS = 4
V3_ARCH = "deepseek-v3-671b"
V3_LAYERS = 4              # 3 dense + 1 MoE of 256 experts, full width
V3_REQUESTS = 4
V3_GEN = 16
# tests/test_models.py's tolerance for prefill-then-decode against one
# parallel forward; held in f32, since one bf16 ulp of a logit near 1 is
# 7.8e-3
V3_TOL = 2e-3
# a differing top-k set is a routing flip, not a fault, where the
# reference path's k-th and (k+1)-th scores are within this
ROUTING_TIE = 1e-5

HY_ARCH = "hymba-1.5b"
HY_PARAMS = 1_350_969_600
HY_WINDOW = 1024
# hymba-1.5b's prefill shape of the flash kernel: GQA group 5 (25 / 5
# heads), D 64, the prompt after 128 meta tokens; at batch 1 in phases 6
# and 9, at the serve batch in phase 15's timing
HY_SHAPE = (SERVE_BATCH, 25, 5, SERVE_PROMPT + 128, 64)
HY_CASE = (1, *HY_SHAPE[1:])
HY_TRAIN_STEPS = 2          # cut from 4 to pay for phase 19's time
XL_ARCH = "xlstm-125m"
XL_PARAMS = 112_730_880
XL_TRAIN_STEPS = 2
XL_TRAIN_LAYERS = 2       # its training cut, one mLSTM and one sLSTM layer
XL_PROMPT = 1024          # its serving prompt (a prefill is ~124,000 launches a 1024)
# xLSTM's f32 state carry at 1e-4: after a prompt this long (rounding of
# ~1e-7 grows to ~2e-5 of a logit by position 32 and ~9e-3 by 2048, in the
# JAX package's model as in this one, measured on a CPU host); over the
# full prompt, against a multiple of the measured rounding floor
XL_CARRY_PROMPT = 32
CARRY_FLOOR_FACTOR = 10
# f32 logits of the SSM and hybrid families: the kernel path against the
# plain-attention path, and a prefill plus one decode step against a prefill
# one token longer (the chunked recurrence's tolerance, tests/test_models.py)
SSM_F32_TOL = 1e-4

PG_ARCH = "paligemma-3b"
PG_PARAMS = 2_508_662_784
# paligemma-3b's prefill shape of the flash kernel: the text prompt alone
# (the reference prefills no image prefix), 8 q heads over 1 kv head (MQA:
# GQA group 8), D 256
PG_SHAPE = (SERVE_BATCH, 8, 1, SERVE_PROMPT, 256)
PG_F32_LAYERS = 2          # full width, f32, batch 1
PG_F32_STEPS = 8           # teacher-forced decode steps, each write clamped
# training: cut from 4 to 2 sequences for the f32 logits over vocab 257216
# (2 x 2048 x 257216 x 4 B = 4.2 GB a copy); 256 prefix embeddings each
PG_TRAIN_BATCH = 2
PG_TRAIN_STEPS = 2
WH_ARCH = "whisper-small"
WH_PARAMS = 263_280_384
# Whisper's previous-text prompt limit: half its 448-token decoder context
WH_PROMPT = 224
WH_F32_STEPS = 8
WH_TRAIN_SEQ = 448
WH_TRAIN_STEPS = 2
# whisper-small's decoder self-attention at the flash kernel's prefill (MHA,
# D 64): the 224 rows padded to 256 by flash_attention_padded
WH_SHAPE = (SERVE_BATCH, 12, 12, 256, 64)
# phase 17: sharded training (qwen3-0.6b as phase 10; deepseek-moe-16b as
# phase 14's 4-layer cut, at batch 2 so that two ranks fit on one card)
SH_STEPS = 2
SH_MESH = (2, 2)                 # (b): 4 ranks over gloo on the one card
SH_DS_MESH = (1, 2)              # (b): expert parallelism over "model"
SH_DS_BATCH = 2
SH_TOL = 2e-2                    # of max |x|, between layouts (bf16 sums)
# each parameter shard's 2-step update against the one-rank run's, in norm:
# ||d - d_1|| / ||d_1||; an unchanged shard reads 1. Measured on an H100
# 80GB HBM3 at 700 W: qwen3-0.6b on 2x2 at most 0.103 (a q_norm, which starts
# at zero: flipped signs of near-zero gradient components), deepseek-moe-16b
# on 1x2 at most 0.173 (an expert's w_gate); medians 0.052 and 0.037
SH_UPDATE_TOL = 0.35
SH_RANK_TIMEOUT_S = 420          # a rank's process group and the join
# phase 18: sharded serving (phase 7's requests) and the roofline against
# the card. On 2x2 the caches hold 16384 slots: L 28 on data 2, so their
# layers go over "data" and their slots over "model"
SV_MESH = (2, 2)
SV_CACHE_LEN = 16384
SV_F32_LAYERS = 2
SV_F32_STEPS = 8
SV_F32_TOL = 1e-4                # of max |logit|, f32, 2x2 against one rank
SV_RANK_BATCHES = 1              # the 2x2 ranks' bf16 batches (gloo-bound, ~40 s each)
# phase 19: gemma2-9b. The prompt is longer than the local layers' window,
# so that their mask bites in the prefill and in decode
G2_ARCH = "gemma2-9b"
G2_PARAMS = 9_241_705_984
G2_WINDOW = 4096
G2_PROMPT = 6144
# the flash kernel's shape at gemma2-9b's prefill: GQA group 2, D 256
G2_SHAPE = (SERVE_BATCH, 16, 8, G2_PROMPT, 256)
G2_F32_LAYERS = 2          # 1 local + 1 global, full width, f32, batch 1
G2_F32_STEPS = 8           # teacher-forced decode steps
# training: a cut of 4 of the 42 layers (2 local, 2 global) at full width,
# one sequence of 8192 (the window bites): ~1.71 B parameters, bf16
# weights and gradients 6.8 GB, f32 moments 13.7 GB, f32 logits over vocab
# 256000 8.4 GB a copy
G2_TRAIN_LAYERS = 4
G2_TRAIN_BATCH = 1
G2_TRAIN_SEQ = 8192
G2_TRAIN_STEPS = 3
# the backward at gemma2-9b's training shape, timed beside SDPA's
G2_BWD_SHAPE = (G2_TRAIN_BATCH, 16, 8, G2_TRAIN_SEQ, 256)
# queries and keys sharing a mean this many times their spread, softcap 50,
# window 4096 on a sequence past it: gemma2-27b's layer (D 128, 32 / 16
# heads, scale 144^-0.5) and gemma2-9b's (D 256, 16 / 8, 256^-0.5)
SHARED_MEAN_RATIOS = (16.0, 32.0)
SHARED_MEAN_SEQ = 4352
SHARED_MEAN_TOL = 1e-2
DRY_CELLS = (("qwen3-0.6b", "train_4k", False), ("qwen3-0.6b", "train_4k", True),
             ("deepseek-v3-671b", "decode_32k", True))
DRY_TIMEOUT_S = 300
ROOF_STEPS = 5                   # phase 10's step on the card; median of steps 2..5
PEAK_BAND = (0.7, 1.3)           # predicted peak over the card's, for that step


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def seeded_inputs(program, num_iters: int, batch: int, seed: int) -> dict:
    """Input streams as the JAX package's tests make them: uniform(-4, 4)
    rounded to 2 decimals, one numpy generator per program."""
    rng = np.random.default_rng(seed)
    return {v: rng.uniform(-4, 4, (num_iters, batch)).astype(np.float32).round(2)
            for v in program.input_nodes()}


def stacked(program, inputs: dict) -> torch.Tensor:
    return torch.stack([torch.as_tensor(inputs[v], device="cuda")
                        for v in program.input_nodes()]).contiguous()


def map_program(dfg: DFG, cgra: CGRA):
    res = map_dfg(dfg, cgra, time_budget_s=30)
    check(res.ok, f"{dfg.name} on {cgra.rows}x{cgra.cols}: {res.reason}")
    return compile_program(res.mapping)


# ------------------------------------------------------------------ phase 3

def opcover_dfg() -> DFG:
    """Every opcode, chained like straight-line code (the JAX package's
    tests/test_kernels_cgra.py::test_all_float_ops_covered)."""
    mid = ["add", "sub", "mul", "div", "min", "max", "neg", "abs", "mov",
           "cmp", "and", "or", "xor", "shl", "shr", "not"]
    ops = ["input", "input", "const"] + mid + ["store"]
    edges, prev = [], 2
    for v in range(3, 3 + len(mid)):
        edges.append(Edge(prev, v))
        if OP_ARITY[ops[v]] == 2:
            edges.append(Edge(v % 2, v))
        prev = v
    edges.append(Edge(prev, len(ops) - 1))
    return DFG(num_nodes=len(ops), edges=edges, ops=ops, name="opcover")


def small_cases():
    re_ = running_example()
    yield "running_example 2x2 b8", re_, CGRA(2, 2), 5, 8, None
    yield "running_example 3x3 b32", re_, CGRA(3, 3), 4, 32, None
    yield "running_example 4x4 b128", re_, CGRA(4, 4), 4, 128, None
    yield "opcover 3x3", opcover_dfg(), CGRA(3, 3), 3, 8, None
    accum = DFG(num_nodes=4, edges=[Edge(0, 1), Edge(1, 2), Edge(2, 1, 1), Edge(2, 3)],
                ops=["input", "phi", "mov", "store"], name="accum")
    yield "phi recurrence 2x2", accum, CGRA(2, 2), 6, 8, None
    big = DFG(num_nodes=4, edges=[Edge(0, 2), Edge(1, 2), Edge(2, 3)],
              ops=["input", "input", "add", "store"], name="overflow")
    yield "1e20 operands 2x2", big, CGRA(2, 2), 2, 8, 1e20


def phase_small() -> None:
    for label, dfg, cgra, iters, batch, const in small_cases():
        prog = map_program(dfg, cgra)
        if const is None:
            inputs = seeded_inputs(prog, iters, batch, seed=0)
        else:
            inputs = {v: np.full((iters, batch), const, np.float32)
                      for v in prog.input_nodes()}
        tables = prog.tables.to("cuda")
        x = stacked(prog, inputs)
        got = cgra_sim(tables, x)
        plain = cgra_sim_torch(tables, x)
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"{label}: kernel != plain version")
        outs_r, trace_r = cgra_sim_reference(prog, inputs, iters)
        check(np.array_equal(got.cpu().numpy(), trace_r), f"{label}: kernel != oracle")
        ref = interpret_dfg(dfg, {v: [float(a) for a in inputs[v][:, 0]] for v in inputs},
                            iters)
        m = prog.mapping
        for v, stream in ref.items():
            cyc = [m.t_abs[v] + it * m.ii for it in range(iters)]
            lane0 = got[cyc, m.placement[v], 0].cpu().numpy()
            np.testing.assert_allclose(lane0, np.asarray(stream, np.float32),
                                       rtol=1e-6, atol=1e-6, err_msg=label)
        if const is not None:
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite trace")
        log(f"  ok  {label}: II={m.ii} C={got.shape[0]} pes={got.shape[1]} B={batch}")


# ------------------------------------------------------------------ phase 4

def drive_main_path(suite: dict) -> dict:
    """Map, lower and run each full-size program through ``cgra_run``; the
    entry points a user calls. Returns per-program state for the checks."""
    runs = {}
    for name in FULL_KERNELS:
        t0 = time.perf_counter()
        prog = map_program(suite[name], CGRA(*FULL_GRID))
        map_s = time.perf_counter() - t0
        inputs = seeded_inputs(prog, FULL_ITERS, FULL_BATCH, seed=1)
        outs, trace = cgra_run(prog, inputs, FULL_ITERS, device="cuda")
        torch.cuda.synchronize()
        runs[name] = dict(prog=prog, inputs=inputs, outs=outs, trace=trace,
                          map_s=map_s)
    return runs


def check_full(name: str, run: dict, chunk: int = FULL_BATCH) -> float:
    """The trace's shape, finiteness, equality with the plain version
    (``chunk`` lanes of it at a time, so that a trace too large to hold
    twice is checked too) and 8 sampled lanes against the oracle. Returns
    max |kernel - plain|."""
    prog, inputs, trace = run["prog"], run["inputs"], run["trace"]
    m = prog.mapping
    C = m.schedule_length + (FULL_ITERS - 1) * m.ii
    check(tuple(trace.shape) == (C, prog.num_pes, FULL_BATCH), f"{name}: trace shape")
    for v, out in run["outs"].items():
        check(tuple(out.shape) == (FULL_ITERS, FULL_BATCH), f"{name}: store {v} shape")
    tables = prog.tables.to("cuda")
    x = stacked(prog, inputs)
    err, same = 0.0, True
    for lo in range(0, FULL_BATCH, chunk):
        part = trace[:, :, lo:lo + chunk]
        # before the plain version exists: isfinite's temporaries are as
        # large as the part, and at 20x20 three traces are held at once
        check(bool(torch.isfinite(part).all()), f"{name}: non-finite trace")
        plain = cgra_sim_torch(tables, x[:, :, lo:lo + chunk].contiguous())
        same = same and torch.equal(part, plain)
        # max |kernel - plain| a few cycles at a time: a whole-trace difference
        # would need as much memory again as the trace
        err = max([err] + [float((part[c:c + 16] - plain[c:c + 16]).abs().max())
                           for c in range(0, C, 16)])
        del plain
    check(same, f"{name}: kernel != plain version (max |d| {err})")
    lanes = np.random.default_rng(2).choice(FULL_BATCH, SAMPLED_LANES, replace=False)
    _, ref = cgra_sim_reference(prog, inputs, FULL_ITERS, lanes=lanes)
    got = trace[:, :, torch.as_tensor(lanes, device="cuda")].cpu().numpy()
    check(np.array_equal(got, ref), f"{name}: sampled lanes != oracle")
    log(f"  ok  {name}: II={m.ii} C={C} ring={prog.ring} nodes={m.dfg.num_nodes} "
        f"map {run['map_s']:.2f} s; trace == plain, lanes {sorted(lanes.tolist())} "
        f"== oracle")
    return err


# ------------------------------------------------------------------ phase 5

def time_ms(fn, runs: int, inner: int = 1) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` after one warm-up;
    each timing spans ``inner`` calls back to back and is divided by it, so
    that a sub-millisecond kernel is not timed with the host's enqueue gap
    before it."""
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


def bound(prog, tables, x: torch.Tensor) -> tuple[float, str, int]:
    """Least time for the card: bytes (each input once, the trace once) over
    HBM bandwidth, or the ops the run's firing nodes do over the f32 rate."""
    C = tables.num_cycles(FULL_ITERS)
    trace_bytes = C * prog.num_pes * FULL_BATCH * 4
    table_bytes = sum(getattr(tables, k).numel() * 4 for k in tables.TENSOR_FIELDS)
    nbytes = trace_bytes + x.numel() * 4 + table_bytes
    firings = prog.mapping.dfg.num_nodes * FULL_ITERS * FULL_BATCH
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = firings / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes", nbytes) if by_bytes >= by_ops else (by_ops, "operations", nbytes)


def phase_timing(runs: dict) -> dict:
    rows = {}
    for name, run in runs.items():
        prog = run["prog"]
        tables = prog.tables.to("cuda")
        x = stacked(prog, run["inputs"])
        shape = (tables.num_cycles(FULL_ITERS), prog.num_pes, FULL_BATCH)
        ms = time_ms(lambda: cgra_sim(tables, x), TIMED_RUNS)
        # the wrapper's torch.zeros alone: the part of `ms` that is the fill
        fill_ms = time_ms(lambda: torch.zeros(shape, device="cuda"), TIMED_RUNS)
        plain_ms = time_ms(lambda: cgra_sim_torch(tables, x), 3)
        bound_ms, bound_by, nbytes = bound(prog, tables, x)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, bytes=nbytes)
        log(f"  {name}: kernel {ms:.4f} ms (median of {TIMED_RUNS}, zero-fill "
            f"included; the fill alone {fill_ms:.4f} ms), plain {plain_ms:.2f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B), "
            f"{bound_ms / ms:.1%} of bound")
    return rows

# ------------------------------------------------------------------ phase 6

def flash_cases():
    """(label, (b, hq, hkv, s, d), dtype, options): every case of the JAX
    package's flash sweep (tests/test_kernels_flash.py) in f32 and in bf16,
    so that every option reaches both kernels, then D = 192 and 256, f16, S
    below one tile, a ragged S through the padding path, hymba-1.5b's
    prefill at batch 1 (GQA group 5, D 64, S 2176) with its window and
    without, in bf16 and f32, and the serve shape."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    sweep = [(f"S{s_len} D{d}", (2, 4, 2, s_len, d), {})
             for s_len in (128, 256, 512) for d in (64, 128)]
    sweep += [(f"GQA {hq}/{hkv}", (1, hq, hkv, 256, 64), {})
              for hq, hkv in ((4, 4), (8, 2), (8, 1))]
    sweep += [(f"window {w}", (1, 2, 2, 256, 64), {"window": w}) for w in (64, 128, 1000)]
    sweep += [(f"softcap {cap:g}", (1, 2, 1, 256, 64), {"softcap": cap})
              for cap in (20.0, 50.0)]
    sweep += [("non-causal", (1, 2, 2, 128, 64), {"causal": False})]
    gemma2 = {"window": 128, "softcap": 50.0}
    sweep += [("gemma2 combination", (2, 8, 4, 512, 128), gemma2)]
    for dtype in (f32, bf16):
        for label, shape, opts in sweep:
            yield f"sweep {label}", shape, dtype, opts
    yield "D256 gemma2", (2, 8, 4, 512, 256), f32, gemma2
    yield "D256 gemma2", (2, 8, 4, 512, 256), bf16, gemma2
    yield "D192", (1, 4, 2, 256, 192), bf16, {}
    yield "D192 window 100", (1, 4, 2, 256, 192), f16, {"window": 100}
    yield "D96 (CUDA cores)", (1, 4, 2, 256, 96), bf16, {}
    yield "f16", (1, 4, 2, 256, 128), f16, {}
    yield "f16 D64", (1, 4, 2, 256, 64), f16, {}
    yield "S48 (one short tile)", (2, 4, 2, 48, 64), bf16, {}
    yield "window 0 (all masked)", (1, 2, 2, 256, 128), bf16, {"window": 0}
    yield "ragged S1000 (padded)", (2, 16, 8, 1000, 128), bf16, {"window": 256, "padded": True}
    for dtype in (bf16, f32):
        yield f"{HY_ARCH} window {HY_WINDOW}", HY_CASE, dtype, {"window": HY_WINDOW}
        yield f"{HY_ARCH} global", HY_CASE, dtype, {}
    yield "serve shape", SERVE_SHAPE, bf16, {}


def tensor_core_path(dtype, d: int) -> bool:
    """Whether flash_attention takes the tensor-core kernel (else the
    CUDA-core one): bf16/f16 at a head dim of whole 64-column boxes."""
    return dtype != torch.float32 and d in (64, 128, 192, 256)


def qkv(shape, dtype, seed: int = 0):
    b, hq, hkv, s_len, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(sh, generator=g, device="cuda").to(dtype)
            for sh in ((b, hq, s_len, d), (b, hkv, s_len, d), (b, hkv, s_len, d))]


def phase_flash() -> float:
    """Each case: the kernel (through its wrapper) against the plain version
    on the same inputs, and the kernel the wrapper chose. Returns the
    largest |kernel - plain| seen."""
    worst = 0.0
    for label, shape, dtype, opts in flash_cases():
        opts = dict(opts)
        q, k, v = qkv(shape, dtype)
        tc_before = flash_attention.tensor_core_launches
        if opts.pop("padded", False):
            got = flash_attention_padded(q, k, v, **opts)
            causal = True
        else:
            got = flash_attention(q, k, v, **opts)
            causal = opts.pop("causal", True)
        torch.cuda.synchronize()
        on_tc = flash_attention.tensor_core_launches - tc_before
        check(on_tc == int(tensor_core_path(dtype, shape[-1])),
              f"flash {label}: {on_tc} tensor-core launches for {dtype} D {shape[-1]}")
        want = flash_attention_torch(q, k, v, causal=causal, **opts)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        err = float((got.float() - want.float()).abs().max())
        ok = (got.dtype == dtype and got.shape == q.shape
              and bool(torch.isfinite(got).all())
              and torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
        check(ok, f"flash {label}: kernel != plain version (max |d| {err:.3g}, tol {tol})")
        if opts.get("window") == 0:
            check(bool((got == 0).all()), f"flash {label}: fully masked rows are not 0")
        worst = max(worst, err)
        path = "tensor cores" if on_tc else "CUDA cores"
        log(f"  ok  {label}: {list(shape)} {str(dtype)[6:]} {opts or ''} [{path}] "
            f"max |kernel - plain| {err:.3g} (tol {tol})")
    return worst


# ------------------------------------------------------------------ phase 7

@contextlib.contextmanager
def captured_attention(layers: tuple) -> dict:
    """The model's flash kernel calls recorded: the dict maps each call
    index in ``layers`` (one call per layer in a forward; remat's
    recomputes come after) to its q, k, v and keywords and, where the
    output takes part in a backward, once that has run, its gradient d
    out."""
    kernel = attention.flash_attention_padded
    seen = {}
    calls = iter(range(10**9))

    def record(q, k, v, **kw):
        i = next(calls)
        out = kernel(q, k, v, **kw)
        if i in layers:
            entry = seen[i] = dict(q=q.detach().clone(), k=k.detach().clone(),
                                   v=v.detach().clone(), kw=kw)
            if out.requires_grad:
                out.register_hook(
                    lambda g, e=entry: e.update(do=g.detach().contiguous().clone()))
        return out

    attention.flash_attention_padded = record
    try:
        yield seen
    finally:
        attention.flash_attention_padded = kernel


@contextlib.contextmanager
def plain_attention():
    """The serving path with the flash kernel's plain version in its place."""
    kernel = attention.flash_attention_padded
    attention.flash_attention_padded = (
        lambda q, k, v, **kw: flash_attention_torch(q, k, v, causal=True, **kw))
    try:
        yield
    finally:
        attention.flash_attention_padded = kernel


def serve_requests(spec, params, queue: list) -> tuple[list, float]:
    """Serve ``queue`` in batches of SERVE_BATCH through ``serve_batch``;
    returns each batch's tokens and the host time (ending in the tokens'
    copy to the host)."""
    out = []
    t0 = time.perf_counter()
    for i in range(0, len(queue), SERVE_BATCH):
        out.append(serve_batch(spec, params, np.stack(queue[i:i + SERVE_BATCH]),
                               SERVE_GEN, cache_len_for(len(queue[i]))))
    return out, time.perf_counter() - t0


def decode_pos(spec, i: int, prompt_len: int = SERVE_PROMPT) -> int:
    """The position of decode step ``i`` after a prompt of ``prompt_len``,
    as ``serve_batch`` decodes (a vlm's run past its cache's end and
    clamp)."""
    return decode_start(spec.cfg, prompt_len) + i


def prefill_input(spec, prompts: np.ndarray):
    """What ``serve_batch`` prefills for ``prompts``, on the card."""
    return prefill_batch(spec.cfg, torch.as_tensor(prompts, device="cuda"))


def time_serve_steps(spec, params, prompts: np.ndarray,
                     gen: int = SERVE_GEN) -> tuple[float, float]:
    """Prefill ms and decode ms per step of one batch (host clock, each
    ending in a synchronise), after the serve run warmed everything."""
    batch = prefill_input(spec, prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = spec.prefill(params, batch, cache_len_for(prompts.shape[1]))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = logits.argmax(-1)[:, None]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = spec.decode_step(params, tok, caches,
                                          decode_pos(spec, i, prompts.shape[1]))
        tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    return prefill_ms, (time.perf_counter() - t0) * 1e3 / (gen - 1)


def profile_serve(spec, params, prompts: np.ndarray, prefill: bool = True) -> None:
    """Where the serving time goes: a torch.profiler window over one prefill
    (with ``prefill``; else the prefill runs outside any window), then one
    over 4 decode steps. Prints each window's host time, the device's busy
    share (kernel time over host time), its kernel launches and its top
    kernels. Only the device's activity is recorded: the kernels are all it
    reads, and the operator events of xlstm-125m's quarter-million launches
    take minutes to sort."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = {}

    def run_prefill():
        state["logits"], state["caches"] = spec.prefill(
            params, prefill_input(spec, prompts), cache_len_for(prompts.shape[1]))

    def decode():
        for i in range(4):
            tok = state["logits"].argmax(-1)[:, None]
            state["logits"], state["caches"] = spec.decode_step(
                params, tok, state["caches"], decode_pos(spec, i, prompts.shape[1]))

    windows = [("prefill", run_prefill)] if prefill else []
    if not prefill:
        run_prefill()
    for label, fn in windows + [("4 decode steps", decode)]:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = sorted(((e.self_device_time_total, e.count, e.key)
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and e.self_device_time_total > 0),
                         reverse=True)
        busy_us = sum(k[0] for k in kernels)
        if not busy_us:
            log(f"  profile {label}: device time not measured (no device events)")
            continue
        log(f"  profile {label}: host {wall_us / 1e3:.2f} ms, device busy "
            f"{busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}), "
            f"{sum(k[1] for k in kernels)} kernel launches; top kernels:")
        for us, count, name in kernels[:5]:
            log(f"    {us / 1e3:9.3f} ms {us / busy_us:6.1%} x{count:<5} {name[:70]}")


def teacher_forced_logits(spec, params, prompts: np.ndarray, forced: np.ndarray,
                          frames: torch.Tensor | None = None,
                          cache_len: int | None = None) -> list:
    """Prefill logits, then each decode step's logits with ``forced``
    tokens at ``serve_batch``'s positions; an audio model encodes
    ``frames`` (default: zeros, as ``serve_batch`` does). The caches hold
    ``cache_len`` slots (default: the serve CLI's)."""
    batch = prefill_input(spec, prompts)
    if frames is not None:
        batch = dict(batch, frames=frames)
    s = prompts.shape[1]
    logits, caches = spec.prefill(params, batch, cache_len or cache_len_for(s))
    out = [logits]
    for i in range(forced.shape[1]):
        tok = torch.as_tensor(forced[:, i:i + 1], device="cuda")
        logits, caches = spec.decode_step(params, tok, caches, decode_pos(spec, i, s))
        out.append(logits)
    return out


def check_prefill_activations(spec, params, prompts: np.ndarray, layers: tuple | None = None,
                              want_kw: dict | None = None) -> float:
    """The kernel on the q/k/v that ``layers`` (default: the first and the
    last) give it in a bf16 prefill of ``prompts``, with their keywords,
    against its plain version (2e-2); returns the largest |kernel - plain|.
    ``want_kw`` maps a layer to keywords its call must have been given."""
    layers = layers or (0, spec.cfg.num_layers - 1)
    with captured_attention(layers) as seen:
        spec.prefill(params, prefill_input(spec, prompts), cache_len_for(prompts.shape[1]))
    check(sorted(seen) == list(layers), f"captured layers {sorted(seen)}, not {layers}")
    for layer, want in (want_kw or {}).items():
        got = {key: seen[layer]["kw"].get(key) for key in want}
        check(got == want, f"layer {layer}'s flash call had {got}, not {want}")
    return max(check_fwd_activations(f"layer {layer} bf16 prefill", e["q"], e["k"], e["v"],
                                     e["kw"])
               for layer, e in sorted(seen.items()))


def check_fwd_activations(label: str, q, k, v, kw: dict) -> float:
    """The kernel, through the model's padded wrapper, on a layer's captured
    q/k/v and keywords against its plain version (2e-2); returns the largest
    |kernel - plain|."""
    got = flash_attention_padded(q, k, v, **kw)
    want = flash_attention_torch(q, k, v, causal=True, **kw)
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all())
          and torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2),
          f"{label} activations: kernel != plain version (max |d| {err:.3g}, tol 2e-2)")
    log(f"  ok  {label} q/k/v {list(q.shape)}/{list(k.shape)} window {kw.get('window')}: "
        f"max |kernel - plain| {err:.3g} (tol 2e-2, |q| max {float(q.float().abs().max()):.3g})")
    return err


def phase_serve() -> int:
    """Serve the requests, check and time them; returns the flash launches
    of the serving run."""
    cfg = get_config(SERVE_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.vocab, cfg.dtype)
          == (28, 1024, 16, 8, 128, 151936, torch.bfloat16),
          f"{SERVE_ARCH} is not at full width")
    spec = build_model(cfg)
    params = spec.init(0, "cuda")
    rng = np.random.default_rng(0)
    queue = [rng.integers(1, cfg.vocab, size=SERVE_PROMPT)
             for _ in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cgra_sim.launches = 0
    flash_attention.launches = 0
    flash_attention.tensor_core_launches = 0
    batches, serve_s = serve_requests(spec, params, queue)
    launches = flash_attention.launches
    tc_launches = flash_attention.tensor_core_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_batches = len(batches)
    log(f"  {SERVE_ARCH}: {spec.param_count(params) / 1e6:.1f} M params, "
        f"{SERVE_REQUESTS} requests in {n_batches} batches of {SERVE_BATCH}, "
        f"prompt {SERVE_PROMPT}, {SERVE_GEN} generated tokens each")
    log(f"  flash_attention launches on the serving path: {launches}, "
        f"{tc_launches} of them the tensor-core kernel; cgra_sim launches "
        f"there: {cgra_sim.launches}")
    check(launches >= cfg.num_layers * n_batches,
          f"the serving path launched flash_attention {launches} times, "
          f"not >= {cfg.num_layers} per batch")
    check(tc_launches >= cfg.num_layers * n_batches,
          f"the bf16 serving path launched the tensor-core kernel {tc_launches} "
          f"times, not >= {cfg.num_layers} per batch")
    for toks in batches:
        check(toks.shape == (SERVE_BATCH, SERVE_GEN), f"served tokens {toks.shape}")
        check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token out of vocab")
    n_tokens = SERVE_REQUESTS * SERVE_GEN
    prefill_ms, decode_ms = time_serve_steps(spec, params, np.stack(queue[:SERVE_BATCH]))
    log(f"  served {n_tokens} tokens in {serve_s:.3f} s ({n_tokens / serve_s:.1f} tok/s); "
        f"prefill {prefill_ms:.2f} ms per batch of {SERVE_BATCH} x {SERVE_PROMPT}, "
        f"decode {decode_ms:.2f} ms per step; peak device memory {peak_gib:.2f} GiB")

    profile_serve(spec, params, np.stack(queue[:SERVE_BATCH]))

    check_prefill_activations(spec, params, np.stack(queue[:SERVE_BATCH]))

    # bf16: the same batch through the plain attention version
    with plain_attention():
        plain_tokens = serve_batch(spec, params, np.stack(queue[:SERVE_BATCH]),
                                   SERVE_GEN, SERVE_CACHE_LEN)
    agree = float((plain_tokens == batches[0]).mean())
    first = float((plain_tokens[:, 0] == batches[0][:, 0]).mean())
    log(f"  bf16 greedy tokens, kernel vs plain attention: {agree:.1%} equal "
        f"({first:.0%} of first tokens); not gated (greedy paths part at near-ties)")

    # f32 at full width: the kernel path against the plain-attention path
    del params
    torch.cuda.empty_cache()
    spec32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    params32 = spec32.init(0, "cuda")
    prompts = np.stack(queue[:SERVE_BATCH])
    forced = batches[0][:, : SERVE_GEN - 1]
    got = teacher_forced_logits(spec32, params32, prompts, forced)
    with plain_attention():
        want = teacher_forced_logits(spec32, params32, prompts, forced)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    for i, (a, b) in enumerate(zip(got, want)):
        what = "prefill" if i == 0 else f"decode step {i}"
        check(a.shape == (SERVE_BATCH, cfg.vocab) and bool(torch.isfinite(a).all()),
              f"f32 {what}: logits {tuple(a.shape)} not finite or misshapen")
        check(torch.allclose(a, b, atol=SERVE_F32_TOL, rtol=SERVE_F32_TOL),
              f"f32 {what}: kernel path != plain-attention path "
              f"(max |d| {errs[i]:.3g}, tol {SERVE_F32_TOL})")
    log(f"  f32 full width, one batch: prefill logits max |d| {errs[0]:.3g}, "
        f"{len(errs) - 1} teacher-forced decode steps max |d| {max(errs[1:]):.3g} "
        f"(tol {SERVE_F32_TOL}, logits max |x| {float(got[0].abs().max()):.3g})")
    return launches


# ------------------------------------------------------------------ phase 8

def flash_bound(shape, itemsize: int, window: int | None = None) -> tuple[float, str]:
    """Least time for the card at ``shape`` (causal, ``window``): the FLOPs
    of the two products over the unmasked pairs, over the bf16 tensor-core
    peak, or q, k, v and out read or written once over HBM bandwidth."""
    b, hq, hkv, s_len, d = shape
    flops = flash_attention_flops(b, hq, s_len, d, window=window)
    nbytes = 2 * (b * hq + b * hkv) * s_len * d * itemsize
    by_ops = flops / BF16_TENSOR_OPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def phase_flash_timing(shape=SERVE_SHAPE, label: str = "serve shape",
                       f32: bool = True, window: int | None = None,
                       plain: bool = True) -> dict:
    """The kernel at ``shape`` (bf16, causal, ``window``) in turns with
    ``scaled_dot_product_attention`` (kernel, sdpa, kernel, sdpa; without a
    window only: sdpa has none), then, with ``plain``, its plain version
    and, with ``f32``, the CUDA-core kernel on the same shape in f32."""
    q, k, v = qkv(shape, torch.bfloat16, seed=1)
    kernel_ms, library_ms = [], []
    for _ in range(2):
        kernel_ms.append(time_ms(lambda: flash_attention(q, k, v, window=window),
                                 TIMED_RUNS, FLASH_INNER))
        if window is None:
            library_ms.append(time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), TIMED_RUNS, FLASH_INNER))
    ms = statistics.median(kernel_ms)
    lib_ms = statistics.median(library_ms) if library_ms else None
    # one launch between the events, the host's enqueue gap included
    single_ms = time_ms(lambda: flash_attention(q, k, v, window=window), TIMED_RUNS)
    plain_ms = (time_ms(lambda: flash_attention_torch(q, k, v, window=window), 3)
                if plain else None)
    bound_ms, bound_by = flash_bound(shape, q.element_size(), window)
    b, hq, hkv, s_len, d = shape
    flops = flash_attention_flops(b, hq, s_len, d, window=window)
    sdpa = (f" in turns with scaled_dot_product_attention "
            f"{', '.join(f'{t:.4f}' for t in library_ms)} ms" if library_ms else "")
    log(f"  {label} {list(shape)} bf16 causal{f' window {window}' if window else ''}, "
        f"tensor-core kernel: {', '.join(f'{t:.4f}' for t in kernel_ms)} ms{sdpa} "
        f"(medians of {TIMED_RUNS} x {FLASH_INNER} back to back); plain "
        f"{f'{plain_ms:.3f} ms' if plain else 'not timed'}; "
        f"bound {bound_ms:.4f} ms ({flops:.4g} FLOP) "
        f"by {bound_by}, {bound_ms / ms:.1%} of bound, {flops / ms / 1e9:.1f} TFLOP/s; "
        f"one launch alone between the events {single_ms:.4f} ms")
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    if not f32:
        return row
    q32, k32, v32 = (t.float() for t in (q, k, v))
    f32_ms = time_ms(lambda: flash_attention(q32, k32, v32), TIMED_RUNS, FLASH_INNER)
    log(f"  the same shape in f32, CUDA-core kernel: {f32_ms:.4f} ms (median of "
        f"{TIMED_RUNS} x {FLASH_INNER}; its operations over the f32 CUDA-core "
        f"peak {flops / F32_OPS_PER_S * 1e3:.4f} ms)")
    return row


# ------------------------------------------------------------------ phase 9

def flash_bwd_cases():
    """Phase 6's cases (the JAX flash sweep in f32 and bf16, D 192/256,
    f16, S 48, window 0, the ragged S through the padding path, hymba's
    GQA-5 shape with window 1024 and global in bf16 and f32), then the
    tensor-core backward's head dims (64, 128 and 256) and options in bf16
    and f16 (GQA groups 1, 2 and 4, window, softcap, S below one tile, a
    ragged S that the kernels see unpadded), then the training shape."""
    for label, shape, dtype, opts in flash_cases():
        if label != "serve shape":
            yield label, shape, dtype, opts
    for dtype in (torch.bfloat16, torch.float16):
        for d in (64, 128, 256):
            yield f"GQA 1 D{d}", (2, 4, 4, 256, d), dtype, {}
            yield f"GQA 2 window 100 D{d}", (1, 8, 4, 384, d), dtype, {"window": 100}
            yield f"GQA 4 softcap 30 D{d}", (1, 8, 2, 256, d), dtype, {"softcap": 30.0}
            yield f"S48 window 16 D{d}", (2, 4, 2, 48, d), dtype, {"window": 16}
            yield f"ragged S200 D{d}", (1, 4, 2, 200, d), dtype, {"ragged": True}
    yield "training shape", TRAIN_SHAPE, torch.bfloat16, {}


def tensor_core_bwd_path(dtype, d: int) -> bool:
    """Whether flash_attention_backward takes the tensor-core kernels (else
    the CUDA-core ones): bf16/f16 at D 64, 128 and 256."""
    return dtype != torch.float32 and d in (64, 128, 256)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over want's max |.| (inf if want is 0 and got is not)."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return err / scale if scale else (0.0 if err == 0 else float("inf"))


def grads_of(fn, q, k, v, do):
    """dq, dk, dv of fn(q, k, v) at cotangent do, by autograd."""
    leaves_ = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves_)
    return torch.autograd.grad(out, leaves_, do)


def training_activations(arch: str = TRAIN_ARCH, batch_size: int = TRAIN_BATCH,
                         seq: int = TRAIN_SEQ, layers: tuple | None = None,
                         num_layers: int | None = None) -> list:
    """(label, q, k, v, d out, keywords) of ``layers``' flash calls (default:
    the first and the last layer's) in one bf16 training step (loss and
    gradients) of ``arch``, cut to ``num_layers`` if given, on a batch of
    ``batch_size`` x ``seq`` (default: phase 10's model and batch, layers 0
    and 27)."""
    cfg = get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    spec = build_model(cfg)
    params = spec.init(0, "cuda")
    batch = SyntheticLM(cfg, batch_size, seq, seed=0).batch_at(0, "cuda")
    layers = layers or (0, cfg.num_layers - 1)
    with captured_attention(layers) as seen:
        loss_and_grads(spec, params, batch)
    check(sorted(seen) == list(layers) and all("do" in e for e in seen.values()),
          f"captured layers {sorted(seen)} (with d out: "
          f"{sorted(i for i, e in seen.items() if 'do' in e)}), not {layers}")
    out = [(f"layer {i} of a bf16 training step", e["q"], e["k"], e["v"], e["do"], e["kw"])
           for i, e in sorted(seen.items())]
    del params, seen
    torch.cuda.empty_cache()
    return out


def check_bwd_case(label: str, q, k, v, do, opts: dict) -> float:
    """The backward (through its wrapper) against its plain version on the
    same q, k, v, output, lse and d out, and against autograd through the
    plain forward; the kernels the wrapper chose; the autograd Function's
    gradients equal the wrapper's; the tensor-core backward gives the same
    bits twice. Returns the largest |kernel - plain|."""
    opts = dict(opts)
    padded = opts.pop("padded", False)
    ragged = opts.pop("ragged", False)       # S no block divides: wrappers only
    dtype, d = q.dtype, q.shape[-1]
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    kw = dict(sm_scale=opts.pop("sm_scale", d ** -0.5), causal=opts.pop("causal", True),
              **opts)
    plain_fwd = lambda a, b_, c: flash_attention_torch(a, b_, c, **kw)  # noqa: E731
    on_tc = tensor_core_bwd_path(dtype, d)
    before = flash_attention.backward_launches
    tc_before = flash_attention.tensor_core_backward_launches
    if padded:
        # the padding path through autograd: F.pad, the Function, slicing
        got = grads_of(lambda a, b_, c: flash_attention_padded(
            a, b_, c, sm_scale=kw["sm_scale"], window=kw.get("window"),
            softcap=kw.get("softcap")), q, k, v, do)
        check(flash_attention.backward_launches == before + 1,
              f"flash bwd {label}: the padded path launched the backward "
              f"{flash_attention.backward_launches - before} times")
        _, lse = flash_attention_torch(q, k, v, return_lse=True, **kw)
        lse_err = 0.0
        launches = 1
    else:
        _, lse = flash_attention_lse(q, k, v, **kw)
        _, want_lse = flash_attention_torch(q, k, v, return_lse=True, **kw)
        live = torch.isfinite(want_lse)
        check(torch.equal(torch.isfinite(lse), live),
              f"flash bwd {label}: lse is -inf on other rows than the plain one's")
        lse_err = float((lse[live] - want_lse[live]).abs().max()) if live.any() else 0.0
        check(lse_err <= 1e-3, f"flash bwd {label}: lse off by {lse_err:.3g}")
        got = flash_attention_backward(q, k, v, lse, do, **kw)
        check(flash_attention.backward_launches == before + 1,
              f"flash bwd {label}: the backward kernel did not run")
        launches = 1
        if not ragged:
            fn_grads = grads_of(lambda a, b_, c: flash_attention(a, b_, c, **kw),
                                q, k, v, do)
            launches = 2
            check(flash_attention.backward_launches == before + 2,
                  f"flash bwd {label}: the autograd Function did not run the kernel")
            check(all(torch.equal(x, y) for x, y in zip(fn_grads, got)),
                  f"flash bwd {label}: the Function's gradients != the wrapper's")
    on = flash_attention.tensor_core_backward_launches - tc_before
    check(on == launches * on_tc, f"flash bwd {label}: {on} tensor-core backward launches "
          f"of {launches} for {dtype} D {d}")
    if on_tc and not padded:
        again = flash_attention_backward(q, k, v, lse, do, **kw)
        check(all(torch.equal(x, y) for x, y in zip(again, got)),
              f"flash bwd {label}: two launches of the tensor-core backward differ")
    torch.cuda.synchronize()
    want = flash_attention_backward_torch(q, k, v, lse, do, **kw)
    auto = grads_of(plain_fwd, q, k, v, do)
    errs, auto_errs = [], []
    for name, g, w, a in zip("qkv", got, want, auto):
        check(g.dtype == dtype and g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"flash bwd {label}: d{name} {g.dtype} {list(g.shape)} or not finite")
        errs.append(rel_err(g, w))
        auto_errs.append(rel_err(g, a))
    check(max(errs) <= tol, f"flash bwd {label}: kernel != plain version "
          f"(dq/dk/dv error {', '.join(f'{e:.3g}' for e in errs)} of max |g|, tol {tol})")
    check(max(auto_errs) <= tol, f"flash bwd {label}: kernel != autograd of the plain "
          f"forward ({', '.join(f'{e:.3g}' for e in auto_errs)} of max |g|, tol {tol})")
    if kw.get("window") == 0:
        check(all(bool((g == 0).all()) for g in got),
              f"flash bwd {label}: fully masked rows give non-zero gradients")
    shape = [*q.shape[:2], k.shape[1], *q.shape[2:]]
    log(f"  ok  {label}: {shape} {str(dtype)[6:]} {opts or ''}"
        f"{' [padded]' if padded else ''} [{'tensor cores' if on_tc else 'CUDA cores'}"
        f"{', same bits twice' if on_tc and not padded else ''}] dq/dk/dv vs plain "
        f"{'/'.join(f'{e:.2g}' for e in errs)}, vs autograd "
        f"{'/'.join(f'{e:.2g}' for e in auto_errs)} of max |g| (tol {tol}); "
        f"lse max |d| {lse_err:.2g}")
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def check_fresh_thread() -> None:
    """The tensor-core forward and backward at hymba's shape (bf16, window
    1024) as the first CUDA work of a new host thread, as autograd's device
    thread meets them when the flash backward is the first node it runs:
    the same bits as on the main thread. (Before the library made the
    device's context current itself, the backward's TMA encoding failed
    there with CUresult 201.)"""
    q, k, v = qkv(HY_CASE, torch.bfloat16, seed=4)
    do = qkv(HY_CASE, torch.bfloat16, seed=5)[0]
    kw = dict(sm_scale=HY_CASE[-1] ** -0.5, window=HY_WINDOW)
    _, lse = flash_attention_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    calls = {"forward": lambda: (flash_attention(q, k, v, **kw),),
             "backward": lambda: flash_attention_backward(q, k, v, lse, do, **kw)}
    for name, fn in calls.items():
        out = {}

        def worker(fn=fn, out=out):
            try:
                out["got"] = fn()
                torch.cuda.synchronize()
            except Exception as e:      # noqa: BLE001 - checked below
                out["err"] = repr(e)

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        check("err" not in out, f"tensor-core {name} in a fresh thread: {out.get('err')}")
        check(all(torch.equal(a, b) for a, b in zip(out["got"], fn())),
              f"tensor-core {name} in a fresh thread != on the main thread")
        log(f"  ok  tensor-core {name} {list(HY_CASE)} bf16 window {HY_WINDOW} as a fresh "
            "thread's first CUDA work: the main thread's bits")


def check_shared_mean(arch: str, ratio: float) -> None:
    """The tensor-core backward on a layer of ``arch`` (gemma2: softcap 50,
    its query scale, window 4096 on SHARED_MEAN_SEQ positions, its heads
    and head dim) whose bf16 queries and keys share a mean ``ratio`` times
    their spread: each gradient within SHARED_MEAN_TOL of its max |g| of the
    plain version in f32. dq is the one at risk: a softcap leaves sum_j
    dS_ij non-zero, and before the epilogue took out dS's rounding errors
    there too, dq kept their sum times the keys' mean."""
    cfg = get_config(arch)
    b, hq, hkv, s_len, d = 1, cfg.num_heads, cfg.num_kv_heads, SHARED_MEAN_SEQ, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(11)

    def shared(h):
        mean = torch.randn((b, h, 1, d), generator=g, device="cuda") * ratio
        return (0.25 * (mean + torch.randn((b, h, s_len, d), generator=g, device="cuda"))
                ).to(torch.bfloat16)

    q, k = shared(hq), shared(hkv)
    v = torch.randn((b, hkv, s_len, d), generator=g, device="cuda").to(torch.bfloat16)
    do = torch.randn((b, hq, s_len, d), generator=g, device="cuda").to(torch.bfloat16)
    kw = dict(sm_scale=cfg.attn_scale, window=cfg.sliding_window, softcap=cfg.attn_softcap)
    check(kw["softcap"] == 50.0 and kw["window"] < s_len, f"{arch}: softcap {kw['softcap']}, "
          f"window {kw['window']} on {s_len} positions")
    _, lse = flash_attention_lse(q, k, v, **kw)
    tc_before = flash_attention.tensor_core_backward_launches
    got = flash_attention_backward(q, k, v, lse, do, **kw)
    check(flash_attention.tensor_core_backward_launches == tc_before + 1,
          f"shared mean {arch}: not the tensor-core backward")
    f32 = [t.float() for t in (q, k, v, do)]
    _, lse32 = flash_attention_torch(*f32[:3], return_lse=True, **kw)
    want = flash_attention_backward_torch(*f32[:3], lse32, f32[3], **kw)
    errs = [rel_err(x, w) for x, w in zip(got, want)]
    check(max(errs) <= SHARED_MEAN_TOL,
          f"shared mean {ratio:g}x {arch}: dq/dk/dv {', '.join(f'{e:.3g}' for e in errs)} "
          f"of max |g| from the plain f32 version (tol {SHARED_MEAN_TOL})")
    log(f"  ok  {arch} layer, q and k sharing a mean {ratio:g}x their spread, "
        f"{[b, hq, hkv, s_len, d]} bf16 softcap {kw['softcap']:g} window {kw['window']} scale "
        f"{kw['sm_scale']:.4g} [tensor cores]: dq/dk/dv vs plain f32 "
        f"{'/'.join(f'{e:.2g}' for e in errs)} of max |g| (tol {SHARED_MEAN_TOL})")


def phase_flash_bwd() -> float:
    """Every case of flash_bwd_cases on seeded inputs, the softcapped
    shared-mean cases at gemma2's layer shapes, the tensor-core kernels in
    a fresh thread, then layers 0 and 27 of a training step. Returns the
    largest |kernel - plain| seen."""
    worst = 0.0
    for label, shape, dtype, opts in flash_bwd_cases():
        q, k, v = qkv(shape, dtype)
        do = qkv(shape, dtype, seed=1)[0]
        worst = max(worst, check_bwd_case(label, q, k, v, do, opts))
    for arch in ("gemma2-27b", G2_ARCH):
        for ratio in SHARED_MEAN_RATIOS:
            check_shared_mean(arch, ratio)
    check_fresh_thread()
    for label, q, k, v, do, kw in training_activations():
        worst = max(worst, check_bwd_case(label, q, k, v, do, kw))
    return worst


# ----------------------------------------------------------------- phase 10

def loss_and_grads(spec, params, batch):
    flat = [p.detach().clone().requires_grad_() for p in leaves(params)]
    loss, _ = spec.loss_fn(unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(params, grads)


def zero_flash_counts() -> None:
    flash_attention.launches = 0
    flash_attention.tensor_core_launches = 0
    flash_attention.backward_launches = 0
    flash_attention.tensor_core_backward_launches = 0


def flash_counts() -> tuple[int, int, int, int]:
    """Forward, tensor-core forward, backward, tensor-core backward launches."""
    return (flash_attention.launches, flash_attention.tensor_core_launches,
            flash_attention.backward_launches,
            flash_attention.tensor_core_backward_launches)


def train_run(spec, opt_cfg, data, steps: int, *, compression: bool) -> dict:
    """``steps`` of training through make_state / make_step / run_training
    in a fresh checkpoint directory (saved at the last step); returns the
    report, per-step host times, the flash launch counts, peak memory, the
    final state and the save's time. The directory is removed."""
    state = make_state(spec, opt_cfg, 0, compression=compression, device="cuda")
    step = make_step(spec, opt_cfg, compression=compression)
    times, ends = [], []

    def timed(st, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(st, batch)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        times.append(ends[-1] - t0)
        return out

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(dir=build_dir, prefix="chip_smoke_ckpt_")
    try:
        fault = FaultConfig(ckpt_dir=ckpt_dir, ckpt_every=steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_flash_counts()
        state, report = run_training(timed, state,
                                     lambda i: data.batch_at(i, "cuda"), steps, fault)
        done = time.perf_counter()
        counts = flash_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        # the last step's end to the runner's return: the save at the last
        # step (device-to-host snapshot and the npz write)
        save_s = done - ends[-1]
        check(report.restarts == 0, f"training restarted {report.restarts} times: "
              "a step raised (run_training catches and retries)")
        check(report.steps_done == steps, f"{report.steps_done} steps, not {steps}")
        check(all(np.isfinite(report.losses)), f"non-finite losses {report.losses}")
        t0 = time.perf_counter()
        back = restore(ckpt_dir, steps, state)
        restore_s = time.perf_counter() - t0
        for (path, a), (_, b) in zip(leaves_with_paths(back), leaves_with_paths(state)):
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"checkpoint leaf {path} does not restore bit for bit")
        del back
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return dict(report=report, times=times, counts=counts, peak_gib=peak_gib,
                state=state, save_s=save_s, restore_s=restore_s)


def check_counts(counts, steps: int, layers: int, what: str) -> None:
    fwd, tc, bwd, tc_bwd = counts
    need = layers * steps
    check(min(counts) >= need,
          f"{what}: flash launches forward {fwd}, tensor-core {tc}, backward {bwd}, "
          f"tensor-core backward {tc_bwd}; each must be >= {layers} per step ({need})")


def profile_step(spec, opt_cfg, state, batch) -> None:
    """One training step under torch.profiler: host time, the device's busy
    share, the top kernels, and each flash kernel's time and launches. Only
    the device's activity is recorded: the kernels are all it reads, and
    sorting a hymba-1.5b step's operator events as well took ~80 s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = make_step(spec, opt_cfg, compression=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        new_state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    del new_state
    kernels = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     reverse=True)
    busy_us = sum(k[0] for k in kernels)
    if not busy_us:
        log("  profile of one step: device time not measured (no device events)")
        return
    bwd_us = sum(k[0] for k in kernels if "flash_bwd" in k[2])
    fwd_us = sum(k[0] for k in kernels if "flash_fwd" in k[2])
    log(f"  profile of one step: host {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({busy_us / wall_us:.1%}); flash backward kernels "
        f"{bwd_us / 1e3:.3f} ms ({bwd_us / busy_us:.1%} of busy), flash forward "
        f"{fwd_us / 1e3:.3f} ms ({fwd_us / busy_us:.1%}); top kernels:")
    for us, count, name in kernels[:8]:
        log(f"    {us / 1e3:9.3f} ms {us / busy_us:6.1%} x{count:<5} {name[:70]}")
    log("  flash kernels of the step: " + "; ".join(
        f"{name.split('(')[0].removeprefix('void ')} {us / 1e3:.3f} ms x{count}"
        for us, count, name in kernels if "flash_" in name))


def phase_train() -> int:
    """Train, check and time; returns the backward launches of the 8-step
    run."""
    cfg = get_config(TRAIN_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.dtype, cfg.remat)
          == (28, 1024, 16, 8, 128, 3072, 151936, torch.bfloat16, True),
          f"{TRAIN_ARCH} is not at full width with remat")
    spec = build_model(cfg)
    # the training CLI's defaults for this many steps
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                          warmup_steps=max(10, TRAIN_STEPS // 20))
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    run = train_run(spec, opt_cfg, data, TRAIN_STEPS, compression=False)
    report, times = run["report"], run["times"]
    check_counts(run["counts"], TRAIN_STEPS, cfg.num_layers, "training")
    lo, hi = FIRST_LOSS_BAND
    check(lo <= report.losses[0] <= hi,
          f"first loss {report.losses[0]:.4f} outside [{lo}, {hi}] (ln vocab "
          f"{np.log(cfg.vocab):.4f})")
    ms = statistics.median(times[TRAIN_TIMED_FROM:]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fwd, tc, bwd, tc_bwd = run["counts"]
    log(f"  {TRAIN_ARCH}: {spec.param_count(run['state']['params']) / 1e6:.1f} M params, "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, bf16, remat; restarts "
        f"{report.restarts}")
    log(f"  losses {', '.join(f'{x:.4f}' for x in report.losses)} (ln vocab "
        f"{np.log(cfg.vocab):.4f})")
    log(f"  flash launches over the run: forward {fwd} ({fwd / TRAIN_STEPS:g} a step), "
        f"tensor-core {tc}, backward {bwd} ({bwd / TRAIN_STEPS:g} a step), tensor-core "
        f"backward {tc_bwd}")
    log(f"  step times {', '.join(f'{t * 1e3:.1f}' for t in times)} ms; median of steps "
        f"{TRAIN_TIMED_FROM + 1}-{TRAIN_STEPS} {ms:.2f} ms/step, {tokens / ms * 1e3:.0f} "
        f"tokens/s; peak device memory {run['peak_gib']:.2f} GiB; checkpoint save at the "
        f"last step {run['save_s']:.2f} s, restore {run['restore_s']:.2f} s (bit for bit)")
    bwd_launches = bwd

    profile_step(spec, opt_cfg, run["state"], data.batch_at(TRAIN_STEPS, "cuda"))
    del run
    torch.cuda.empty_cache()

    run = train_run(spec, opt_cfg, data, COMPRESSION_STEPS, compression=True)
    check_counts(run["counts"], COMPRESSION_STEPS, cfg.num_layers, "compressed training")
    log(f"  --grad-compression: {COMPRESSION_STEPS} steps, losses "
        f"{', '.join(f'{x:.4f}' for x in run['report'].losses)}, restarts "
        f"{run['report'].restarts}, peak device memory {run['peak_gib']:.2f} GiB, step "
        f"times {', '.join(f'{t * 1e3:.1f}' for t in run['times'])} ms")
    del run
    torch.cuda.empty_cache()

    # f32 at full width, batch 1 x 2048: kernels against plain attention
    spec32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    params32 = spec32.init(0, "cuda")
    batch = SyntheticLM(cfg, 1, TRAIN_SEQ, seed=1).batch_at(0, "cuda")
    zero_flash_counts()
    loss, grads = loss_and_grads(spec32, params32, batch)
    fwd, tc, bwd, tc_bwd = flash_counts()
    check((fwd, tc, bwd, tc_bwd) == (2 * cfg.num_layers, 0, cfg.num_layers, 0),
          f"f32 step: forward {fwd}, tensor-core {tc}, backward {bwd}, tensor-core "
          f"backward {tc_bwd} launches; expected {2 * cfg.num_layers}, 0, "
          f"{cfg.num_layers}, 0")
    with plain_attention():
        plain_loss, plain = loss_and_grads(spec32, params32, batch)
    check(flash_counts() == (fwd, tc, bwd, tc_bwd),
          "the plain-attention step launched a kernel")
    loss_err = abs(float(loss) - float(plain_loss))
    check(loss_err <= PARITY_LOSS_TOL * max(1.0, abs(float(plain_loss))),
          f"f32 loss {float(loss):.7f} vs plain attention {float(plain_loss):.7f}")
    worst, worst_path = 0.0, ""
    for (path, g), (_, w) in zip(leaves_with_paths(grads), leaves_with_paths(plain)):
        err = rel_err(g, w)
        check(err <= PARITY_GRAD_TOL, f"f32 gradient {path}: {err:.3g} of its max |g| "
              f"(tol {PARITY_GRAD_TOL})")
        if err > worst:
            worst, worst_path = err, path
    log(f"  f32 full width, batch 1 x {TRAIN_SEQ}: loss {float(loss):.7f} vs plain "
        f"attention {float(plain_loss):.7f} (|d| {loss_err:.3g}); gradients of "
        f"{len(leaves(grads))} leaves within {worst:.3g} of each leaf's max |g| (worst "
        f"{worst_path}; tol {PARITY_GRAD_TOL}); {bwd} backward launches")
    return bwd_launches


# ----------------------------------------------------------------- phase 11

def flash_bwd_bound(shape, itemsize: int, window: int | None = None) -> tuple[float, str]:
    """Least time for the card at ``shape`` (causal, ``window``): the five
    products of the backward (2.5x the forward's FLOPs) over the bf16
    tensor-core peak, or q, k, v, d out and lse read and dq, dk, dv written
    once over HBM bandwidth."""
    b, hq, hkv, s_len, d = shape
    flops = flash_attention_flops(b, hq, s_len, d, window=window, backward=True)
    nbytes = (3 * b * hq + 4 * b * hkv) * s_len * d * itemsize + b * hq * s_len * 4
    by_ops = flops / BF16_TENSOR_OPS_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def phase_flash_bwd_timing(shape=TRAIN_SHAPE, label: str = "training shape",
                           f32: bool = True, window: int | None = None,
                           softcap: float | None = None, plain: bool = True) -> dict:
    """The tensor-core backward at ``shape`` (bf16, causal, ``window``,
    ``softcap``) in turns with the backward of
    ``scaled_dot_product_attention`` through autograd (kernel, sdpa,
    kernel, sdpa; without a window or softcap only: sdpa takes neither),
    then, with ``plain``, its plain version and, with ``f32``, the
    CUDA-core backward on the same shape in f32."""
    q, k, v = qkv(shape, torch.bfloat16, seed=2)
    do = qkv(shape, torch.bfloat16, seed=3)[0]
    kw = dict(sm_scale=shape[-1] ** -0.5, window=window, softcap=softcap)
    _, lse = flash_attention_lse(q, k, v, **kw)
    with_sdpa = window is None and softcap is None
    if with_sdpa:
        ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
    tc_before = flash_attention.tensor_core_backward_launches
    kernel_ms, library_ms = [], []
    for _ in range(2):
        kernel_ms.append(time_ms(lambda: flash_attention_backward(q, k, v, lse, do, **kw),
                                 TIMED_RUNS, BWD_INNER))
        if with_sdpa:
            library_ms.append(time_ms(lambda: torch.autograd.grad(
                sdpa_out, (ql, kl, vl), do, retain_graph=True), TIMED_RUNS, BWD_INNER))
    check(flash_attention.tensor_core_backward_launches - tc_before
          == 2 * (1 + TIMED_RUNS * BWD_INNER), "the timed backward is not the tensor-core one")
    ms = statistics.median(kernel_ms)
    lib_ms = statistics.median(library_ms) if library_ms else None
    plain_ms = (time_ms(lambda: flash_attention_backward_torch(q, k, v, lse, do, **kw), 3)
                if plain else None)
    bound_ms, bound_by = flash_bwd_bound(shape, q.element_size(), window)
    b, hq, hkv, s_len, d = shape
    flops = flash_attention_flops(b, hq, s_len, d, window=window, backward=True)
    sdpa = (f" in turns with the backward of scaled_dot_product_attention "
            f"{', '.join(f'{t:.4f}' for t in library_ms)} ms" if library_ms else "")
    opts = "".join([f" window {window}" if window else "",
                    f" softcap {softcap:g}" if softcap else ""])
    log(f"  {label} {list(shape)} bf16 causal{opts}, tensor-core backward: "
        f"{', '.join(f'{t:.4f}' for t in kernel_ms)} ms{sdpa} "
        f"(medians of {TIMED_RUNS} x {BWD_INNER} back to back); plain "
        f"{f'{plain_ms:.3f} ms' if plain else 'not timed'}; "
        f"bound {bound_ms:.4f} ms by {bound_by} ({flops:.4g} FLOP), {bound_ms / ms:.1%} of "
        f"bound, {flops / ms / 1e9:.1f} TFLOP/s of the bound's FLOP, "
        f"{1.8 * flops / ms / 1e9:.1f} of the 9 products done")
    if not f32:
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                    bound_by=bound_by)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    _, lse32 = flash_attention_lse(q32, k32, v32, **kw)
    f32_ms = time_ms(lambda: flash_attention_backward(q32, k32, v32, lse32, do32, **kw),
                     3)
    log(f"  the same shape in f32, CUDA-core backward: {f32_ms:.4f} ms (median of 3; its "
        f"FLOP over the f32 CUDA-core peak {flops / F32_OPS_PER_S * 1e3:.4f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# ----------------------------------------------------------------- phase 12

def cache_entries(root: Path) -> dict:
    """The persistent cache's entries by DFG hash: (ii, t_abs, placement,
    routes) as the cold run wrote them (one entry per kernel)."""
    entries = {}
    for path in sorted(root.rglob("*.json")):
        e = json.loads(path.read_text())
        check(e["key"][0] not in entries, f"two cache entries for {e['key'][0]}")
        entries[e["key"][0]] = (e["ii"], e["t_abs"], e["placement"],
                                [tuple(r) for r in e["routes"]])
    return entries


def run_mapping(name: str, mapping, map_s: float) -> tuple[dict, dict]:
    """Lower ``mapping``, execute it through ``cgra_run`` at full size and
    hold the trace against the plain version and the oracle (phase 4's
    check); the trace is freed before the next one. Returns the input
    streams and the store streams, on the host."""
    prog = compile_program(mapping)
    inputs = seeded_inputs(prog, FULL_ITERS, FULL_BATCH, seed=1)
    outs, trace = cgra_run(prog, inputs, FULL_ITERS, device="cuda")
    torch.cuda.synchronize()
    check_full(name, dict(prog=prog, inputs=inputs, outs=outs, trace=trace,
                          map_s=map_s))
    stores = {v: out.cpu().numpy() for v, out in outs.items()}
    del outs, trace
    torch.cuda.empty_cache()
    return inputs, stores


def phase_api(smi: str) -> tuple[int, dict]:
    """The compiler API path (see the module docstring, item 12). Returns
    cgra_sim's launches over the phase's executions and heartwall's 50x50
    timing row."""
    t_phase = time.perf_counter()
    suite = load_suite()
    names = list(suite)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    (ROOT / "build").mkdir(exist_ok=True)
    cache_dir = Path(tempfile.mkdtemp(prefix="api-cache-", dir=ROOT / "build"))
    report_path = cache_dir.with_name(cache_dir.name + "-report.json")
    cgra_sim.launches = 0
    try:
        # 1. cold premap through the CLI, in a process that never touches CUDA
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.compile", "--suite",
             "--size", str(API_GRID), "--profile", "fast", "--jobs", str(API_JOBS),
             "--deadline-s", str(API_DEADLINE_S), "--cache-dir", str(cache_dir),
             "--report", str(report_path), "--quiet"],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
        cold_s = time.perf_counter() - t0
        check(out.returncode == 0, f"compile CLI exited {out.returncode}: {out.stderr[-2000:]}")
        report = json.loads(report_path.read_text())
        rows = {j["name"]: j for j in report["jobs"]}
        check(sorted(rows) == sorted(names) and report["ok"], "cold premap: a kernel failed")
        check(report["num_workers"] == API_JOBS, f"cold premap ran {report['num_workers']} workers")
        check(report["cache"]["solved"] == len(names), f"cold premap: {report['cache']}")
        log(f"  cold premap (python -m repro_torch.compile, {API_JOBS} workers): "
            f"{len(names)} kernels on {API_GRID}x{API_GRID} in {cold_s:.2f} s "
            f"(report wall {report['wall_s']} s)")
        log("    II port/reference: " + ", ".join(
            f"{n} {rows[n]['ii']}/{REFERENCE_II_20[n]}" for n in names))
        entries = cache_entries(cache_dir)
        check(len(entries) == len(names), f"{len(entries)} cache entries, not {len(names)}")

        # 2. warm session in process: every kernel a disk hit, nothing solved
        clear_mapping_cache()
        t0 = time.perf_counter()
        comp = Compiler(CGRA(API_GRID, API_GRID),
                        resolve_options("fast", cache_dir=str(cache_dir)))
        warm = comp.compile_batch(list(suite.values()))
        warm_s = time.perf_counter() - t0
        c = warm.cache_counters
        check(warm.ok and c["disk_hits"] == len(names) and c["solved"] == 0
              and c["failed"] == 0, f"warm session: {c}")
        check(warm.num_workers > 1, "warm session fell back to one process")
        for r in warm:
            m = r.mapping
            got = (m.ii, m.t_abs, m.placement, [tuple(x) for x in m.routes_spec()])
            check(r.source == "disk", f"{r.name}: served from {r.source}")
            check(got == entries[suite[r.name].stable_hash()]
                  and m.ii == rows[r.name]["ii"], f"{r.name}: warm mapping != cold")
        log(f"  warm session (Compiler.compile_batch, {warm.num_workers} workers): "
            f"{c['disk_hits']} disk hits, {c['solved']} solved in {warm_s:.2f} s; "
            f"every mapping equals the cold run's")

        # 3. execute every warm mapping at full size
        for r in warm:
            run_mapping(r.name, r.mapping, rows[r.name]["wall_s"])

        # 4. the annealing engine on 2500 PEs
        big = Compiler(LARGE_PRESET, resolve_options("fast", space_backend="anneal"))
        large = {}
        for name in LARGE_KERNELS:
            res = big.compile(suite[name])
            check(res.ok, f"{name} on {LARGE_PRESET}: {res.reason}")
            check(res.space_backend == "anneal",
                  f"{name} on {LARGE_PRESET}: placed by {res.space_backend}")
            check(res.mapping.validate() == [], f"{name}: invalid 50x50 mapping")
            check_equivalence(res.mapping)
            prog = compile_program(res.mapping)
            inputs = seeded_inputs(prog, FULL_ITERS, FULL_BATCH, seed=1)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            outs, trace = cgra_run(prog, inputs, FULL_ITERS, device="cuda")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            err = check_full(f"{name} ({LARGE_PRESET}, {res.space_backend})",
                             dict(prog=prog, inputs=inputs, outs=outs, trace=trace,
                                  map_s=res.wall_s), chunk=LANE_CHUNK)
            log(f"      trace {trace.numel() * 4 / 1e9:.1f} GB checked in lane chunks "
                f"of {LANE_CHUNK} (max |d| {err}); peak device memory "
                f"{peak / 2**30:.2f} GiB")
            large[name] = (prog, inputs)
            del outs, trace
            torch.cuda.empty_cache()

        # 5. the heterogeneous preset
        hetero = Compiler(HETERO_PRESET, resolve_options(
            "fast", jobs=API_JOBS, deadline_s=API_DEADLINE_S))
        t0 = time.perf_counter()
        batch = hetero.compile_batch(list(suite.values()))
        hetero_s = time.perf_counter() - t0
        failed = [r.name for r in batch if not r.ok]
        check(not failed, f"{HETERO_PRESET}: not mapped: {failed}")
        check(batch.num_workers == API_JOBS, f"{HETERO_PRESET}: {batch.num_workers} workers")
        log(f"  {HETERO_PRESET}: {len(batch)} kernels mapped in {hetero_s:.2f} s "
            f"({batch.num_workers} workers); II " +
            ", ".join(f"{r.name} {r.ii}" for r in batch))
        for r in batch:
            cgra = hetero.cgra
            check(all(cgra.capable(r.mapping.placement[v], op_class(r.mapping.dfg.ops[v]))
                      for v in r.mapping.dfg.nodes), f"{r.name}: op on an incapable PE")
            run_mapping(f"{r.name} ({HETERO_PRESET})", r.mapping, r.wall_s)
        launches = cgra_sim.launches          # read before any timing launch
        want = 2 * len(names) + len(LARGE_KERNELS)
        check(launches == want, f"phase 12 launched cgra_sim {launches} times, not {want}")

        # heartwall's kernel and its zero-fill alone, as phase 5 times them
        prog, inputs = large[LARGE_KERNELS[0]]
        tables = prog.tables.to("cuda")
        x = stacked(prog, inputs)
        shape = (tables.num_cycles(FULL_ITERS), prog.num_pes, FULL_BATCH)
        ms = time_ms(lambda: cgra_sim(tables, x), TIMED_RUNS)
        fill_ms = time_ms(lambda: torch.zeros(shape, device="cuda"), TIMED_RUNS)
        bound_ms, bound_by, nbytes = bound(prog, tables, x)
        log(f"  {LARGE_KERNELS[0]} {LARGE_PRESET} on {smi}: kernel {ms:.4f} ms "
            f"(median of {TIMED_RUNS}, zero-fill included; the fill alone "
            f"{fill_ms:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B), "
            f"{bound_ms / ms:.1%} of bound")
        large_row = dict(ms=ms, fill_ms=fill_ms, bound_ms=bound_ms, bound_by=bound_by)
        del large, tables, x
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        report_path.unlink(missing_ok=True)

    # 6. the example users start from, on the card
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"quickstart_torch.py exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    check("cgra_sim on cuda" in out.stdout, "quickstart_torch.py did not run on the card")
    log(f"  examples/quickstart_torch.py: exit 0 ({out.stdout.strip().splitlines()[-1]})")
    log(f"  cgra_sim launches in phase 12: {launches}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, large_row


# ----------------------------------------------------------------- phase 13

def mac_body(ins, carried):
    """tests/test_frontend.py's multiply-accumulate loop."""
    acc = carried["acc"] + ins[0] * ins[1]
    return [acc], {"acc": acc}


def mixed_body(ins, carried):
    """tests/test_frontend.py's mixed-op body with constants."""
    x = (ins[0] + 2.0) * ins[1] - 1.0
    y = abs(-x).min(100.0)
    return [y], {}


def all_ops_body(ins, carried):
    """Every operator ``Var`` overloads (the bitwise ops, shifts, compare,
    ``min``/``max``, the reflected ones), with a carried accumulator; every
    divisor is at least 1, so the streams stay finite."""
    a, b, c = ins
    s = a + b
    d = 1.5 - a
    e = 2.0 + b
    f = 3.0 * c
    h = (s * d) / (abs(e) + 1.0)
    i = (s & 255.0) | (b ^ c)
    j = (i << 2.0) >> (a - 1.0)
    k = -(~j)
    n = k.min(h).max(f > h)
    acc = carried["acc"] + n - f
    return [acc, j], {"acc": acc}


FRONTEND_BODIES = (("mac", mac_body, 2, ["acc"]), ("mixed", mixed_body, 2, []),
                   ("all_ops", all_ops_body, 3, ["acc"]))


def same_values(a, b) -> bool:
    """``torch.equal`` that also takes NaN for NaN: random programs may
    overflow, and the trace holds what the ALU gives there."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def run_fuzz_case(label: str, mapping, seed: int) -> int:
    """Execute one fuzz mapping through ``cgra_run`` at FUZZ_BATCH x
    FUZZ_ITERS: the trace equals the plain version and up to 8 sampled lanes
    the oracle (NaN for NaN). A program without an input stream runs one
    lane, as ``cgra_run`` defines it. Returns the lanes run."""
    prog = compile_program(mapping)
    inputs = seeded_inputs(prog, FUZZ_ITERS, FUZZ_BATCH, seed=seed)
    _, trace = cgra_run(prog, inputs, FUZZ_ITERS, device="cuda")
    batch = trace.shape[2]
    check(tuple(trace.shape) == (prog.mapping.schedule_length + (FUZZ_ITERS - 1) * prog.ii,
                                 prog.num_pes, FUZZ_BATCH if inputs else 1),
          f"{label}: trace shape {tuple(trace.shape)}")
    tables = prog.tables.to("cuda")
    x = (stacked(prog, inputs) if inputs
         else torch.zeros((0, FUZZ_ITERS, 1), device="cuda"))
    check(same_values(trace, cgra_sim_torch(tables, x)), f"{label}: kernel != plain version")
    lanes = np.random.default_rng(seed).choice(batch, min(SAMPLED_LANES, batch),
                                               replace=False)
    _, ref = cgra_sim_reference(prog, inputs, FUZZ_ITERS, lanes=lanes if inputs else None)
    got = trace[:, :, torch.as_tensor(lanes, device="cuda")].cpu().numpy()
    check(np.array_equal(got, ref, equal_nan=True), f"{label}: sampled lanes != oracle")
    return batch


def wait_for_daemon(proc, sock: str) -> float:
    """Poll ``DaemonClient.ping`` until the daemon answers; fails when the
    deadline passes or the process exits. Returns the seconds it took."""
    t0 = time.perf_counter()
    while True:
        check(proc.poll() is None, f"daemon exited {proc.returncode} before answering")
        try:
            with DaemonClient(sock, timeout_s=5) as c:
                if c.ping():
                    return time.perf_counter() - t0
        except DaemonError:
            pass
        check(time.perf_counter() - t0 < DAEMON_START_S,
              f"daemon did not answer ping within {DAEMON_START_S} s")
        time.sleep(0.1)


def daemon_requests(names: list) -> list:
    """The suite once, and each of DAEMON_DUPLICATED from DAEMON_DUP_CLIENTS
    clients: one request per client thread."""
    return [n for n in names if n not in DAEMON_DUPLICATED] + [
        n for n in DAEMON_DUPLICATED for _ in range(DAEMON_DUP_CLIENTS)]


def phase_daemon() -> int:
    """The daemon, frontend, fuzz and placement paths (see the module
    docstring, item 13). Returns cgra_sim's launches over the phase."""
    t_phase = time.perf_counter()
    suite = load_suite()
    names = list(suite)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="daemon-", dir=ROOT / "build"))
    cache_dir, trace_dir = work / "cache", work / "traces"
    # AF_UNIX paths hold at most 107 bytes: the socket lives in a short
    # temporary directory, not under a checkout that may lie deep
    sock_dir = tempfile.mkdtemp(prefix="rtd-")
    if len(sock_dir) > 80:
        shutil.rmtree(sock_dir)
        sock_dir = tempfile.mkdtemp(prefix="rtd-", dir="/tmp")
    sock = os.path.join(sock_dir, "d.sock")
    log_path = work / "serve.log"
    proc = None
    cgra_sim.launches = 0
    try:
        # (a) the daemon, started as its user starts it: a fresh process,
        # so no CUDA state is forked
        with open(log_path, "w") as serve_log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.daemon", "serve", "--socket", sock,
                 "--rows", str(API_GRID), "--cols", str(API_GRID), "--profile", "fast",
                 "--time-budget-s", str(DAEMON_BUDGET_S),
                 "--workers", str(DAEMON_WORKERS), "--cache-dir", str(cache_dir),
                 "--trace-dir", str(trace_dir), "--rotate-every", str(DAEMON_ROTATE)],
                env=env, cwd=ROOT, stdout=serve_log, stderr=subprocess.STDOUT)
        up_s = wait_for_daemon(proc, sock)
        requests = daemon_requests(names)
        gate = threading.Barrier(len(requests))

        def one(name):
            with DaemonClient(sock, timeout_s=DAEMON_REQUEST_S) as c:
                gate.wait(timeout=60)            # every client sends at once
                return name, c.compile(suite[name], tenant=f"client-{name}")

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as pool:
            rows = list(pool.map(one, requests))
        cold_s = time.perf_counter() - t0
        bad = [(n, r["failure"], r["reason"]) for n, r in rows if not r["ok"]]
        check(not bad, f"daemon rows failed: {bad}")
        ii, solve_s = {}, {}
        for n, r in rows:
            check(ii.setdefault(n, r["ii"]) == r["ii"], f"{n}: duplicates differ in II")
            solve_s[n] = r["wall_s"]
        with DaemonClient(sock) as c:
            stats = c.stats()
        st = {k: stats[k] for k in ("submitted", "completed", "shed", "failed",
                                    "coalesced", "cancelled_in_queue", "solves",
                                    "warm_memory", "warm_disk")}
        log(f"  daemon (python -m repro_torch.daemon serve, {DAEMON_WORKERS} workers, "
            f"{API_GRID}x{API_GRID}, fast): up in {up_s:.2f} s; {len(requests)} requests "
            f"from {len(requests)} clients at once ({len(DAEMON_DUPLICATED)} kernels x "
            f"{DAEMON_DUP_CLIENTS}) in {cold_s:.2f} s; {st}")
        log(f"    speculation (not gated): {stats['speculative']}")
        # completed counts the requests a worker ran: a coalesced follower
        # receives its leader's row and is never counted as completed
        # (server.py: coalesced at admission, completed in
        # _record_completion), so completed + coalesced == submitted
        check(st["submitted"] == len(requests), f"daemon stats: {st}")
        check(st["completed"] + st["coalesced"] == st["submitted"]
              and st["shed"] == 0 and st["failed"] == 0 and st["cancelled_in_queue"] == 0,
              f"daemon stats: {st}")
        check(st["solves"] + st["warm_memory"] + st["warm_disk"] + st["coalesced"]
              == st["submitted"], f"daemon stats do not account for every request: {st}")
        check(st["solves"] <= len(names), f"daemon solved {st['solves']} times "
              f"for {len(names)} kernels")
        backends = sorted({r["backend"] for _, r in rows})
        log("    II: " + ", ".join(f"{n} {ii[n]}" for n in names) + "; time backend "
            + ", ".join(backends))
        if available_backends()["z3"]:
            check(backends == ["z3"], f"auto took {backends}, not z3, where z3 is importable")
            check(cold_s < Z3_SUITE_ALONE_S, f"the daemon on z3 took {cold_s:.2f} s cold, "
                  f"not under the {Z3_SUITE_ALONE_S} s z3 takes for the suite alone")
        with DaemonClient(sock) as c:
            check(c.shutdown(), "daemon refused shutdown")
        rc = proc.wait(timeout=60)
        check(rc == 0, f"daemon exited {rc}: {log_path.read_text()[-2000:]}")
        check(not os.path.exists(sock), "the daemon left its socket behind")
        segments = sorted(trace_dir.glob("trace-*.json"))
        check(len(segments) >= 2, f"{len(segments)} trace segments rotated")
        for seg in segments:
            out = subprocess.run(
                [sys.executable, str(ROOT / "tools" / "trace_report.py"), str(seg), "--check"],
                capture_output=True, text=True, timeout=120)
            check(out.returncode == 0, f"trace_report {seg.name}: {out.stdout}{out.stderr}")
        spans = sum(len(json.loads(seg.read_text())["traceEvents"]) for seg in segments)
        log(f"    shutdown: exit 0, socket removed; tools/trace_report.py --check read "
            f"{len(segments)} rotated segments ({spans} events)")

        # the daemon's cache serves a warm in-process session
        clear_mapping_cache()
        t0 = time.perf_counter()
        comp = Compiler(CGRA(API_GRID, API_GRID),
                        resolve_options("fast", cache_dir=str(cache_dir)))
        warm = comp.compile_batch(list(suite.values()))
        warm_s = time.perf_counter() - t0
        c = warm.cache_counters
        check(warm.ok and c["disk_hits"] == len(names) and c["solved"] == 0
              and c["failed"] == 0, f"warm session on the daemon's cache: {c}")
        for r in warm:
            check(r.source == "disk" and r.ii == ii[r.name],
                  f"{r.name}: warm {r.source} II {r.ii}, daemon II {ii[r.name]}")
        log(f"    warm Compiler session on the daemon's cache: {c['disk_hits']} disk "
            f"hits, {c['solved']} solved in {warm_s:.2f} s; IIs equal the daemon's")
        for r in warm:
            check_equivalence(r.mapping)
            run_mapping(f"{r.name} (daemon)", r.mapping, solve_s[r.name])

        # (b) the tracing frontend
        for label, body, num_inputs, carried in FRONTEND_BODIES:
            dfg = trace_loop(body, num_inputs=num_inputs, carried=carried, name=label)
            t0 = time.perf_counter()
            res = map_dfg(dfg, CGRA(*FULL_GRID), time_budget_s=30)
            check(res.ok, f"traced {label} on {FULL_GRID}: {res.reason}")
            check_equivalence(res.mapping)
            inputs, stores = run_mapping(f"traced {label}", res.mapping,
                                         time.perf_counter() - t0)
            if label == "mac":
                a, b = sorted(inputs)
                want = np.cumsum(inputs[a] * inputs[b], axis=0, dtype=np.float32)
                (got,) = stores.values()
                err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
                check(np.allclose(got, want, rtol=MAC_RTOL, atol=0),
                      f"traced mac != running sum of a*b (max rel {err})")
                log(f"      mac stores == numpy running sum of a*b over all "
                    f"{FULL_BATCH} lanes (max rel err {err}, tolerance {MAC_RTOL})")

        # (c) the fuzz generator as a correctness harness for the kernel
        t0 = time.perf_counter()
        before = cgra_sim.launches
        mapped, lanes_run, map_s = 0, 0, 0.0
        for fabric, kw in FUZZ_FABRICS:
            cgra = CGRA(**kw)
            for seed in range(FUZZ_SEEDS):
                label = f"fuzz seed={seed} fabric={fabric}"
                t1 = time.perf_counter()
                res = map_dfg(random_dfg(seed), cgra, space_backend="exact", **FUZZ_MAP_KW)
                map_s += time.perf_counter() - t1
                if not res.ok:
                    continue
                check(res.mapping.validate() == [], f"{label}: invalid mapping")
                check_equivalence(res.mapping)
                lanes_run += run_fuzz_case(label, res.mapping, seed)
                mapped += 1
        fuzz_s = time.perf_counter() - t0
        cases = FUZZ_SEEDS * len(FUZZ_FABRICS)
        launches = cgra_sim.launches
        log(f"  fuzz: random_dfg seeds 0-{FUZZ_SEEDS - 1} on "
            f"{', '.join(f for f, _ in FUZZ_FABRICS)} (exact, deterministic): {mapped} of "
            f"{cases} cases mapped ({map_s:.1f} s on the host), each run at "
            f"{FUZZ_BATCH} x {FUZZ_ITERS} ({lanes_run} lanes in all; "
            f"{launches - before} cgra_sim launches) == plain == oracle in {fuzz_s:.1f} s")
        want = len(names) + len(FRONTEND_BODIES) + mapped
        check(launches == want, f"phase 13 launched cgra_sim {launches} times, not {want}")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(sock_dir, ignore_errors=True)

    # (d) the placement example's twin
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "pipeline_placement_torch.py")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"pipeline_placement_torch.py exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    check(out.stdout.count("single-hop flows 100%") == 5,
          "pipeline_placement_torch.py: a placement is not all single-hop")
    log(f"  examples/pipeline_placement_torch.py: exit 0 "
        f"({out.stdout.strip().splitlines()[-1][:100]}...)")
    log(f"  cgra_sim launches in phase 13: {launches}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------------- phase 14

@contextlib.contextmanager
def captured_routing(inputs: bool = False) -> list:
    """Each MoE layer call's routing, in call order: its top-k expert ids
    as a sorted set [T, k], the gap between the k-th and (k+1)-th best
    scores [T], the dispatch's kept assignments [T, k] and, with
    ``inputs``, the router's input rows [T, d]."""
    routing, dispatch = moe._routing, moe._dispatch_slots
    seen = []

    def route(params, x_flat, cfg):
        out = routing(params, x_flat, cfg)
        logits = x_flat.float() @ params["router"]
        scores = (torch.sigmoid(logits) if cfg.moe.score_fn == "sigmoid"
                  else torch.softmax(logits, dim=-1))
        best = torch.topk(scores, cfg.moe.top_k + 1, dim=-1).values
        seen.append(dict(ids=out[0].sort(-1).values, gap=best[:, -2] - best[:, -1]))
        if inputs:
            seen[-1]["x"] = x_flat.detach().clone()
        return out

    def slots(expert_ids, capacity):
        out = dispatch(expert_ids, capacity)
        seen[-1]["kept"] = out[1].view(seen[-1]["ids"].shape)
        return out

    moe._routing, moe._dispatch_slots = route, slots
    try:
        yield seen
    finally:
        moe._routing, moe._dispatch_slots = routing, dispatch


def dropped(seen: list) -> int:
    """Assignments past their expert's capacity in the captured calls."""
    return sum(int((~c["kept"]).sum()) for c in seen)


def compare_rows(rows, tol: float, what: str) -> tuple[float, int, int]:
    """Logit rows of two paths, each with its token's routing in every MoE
    layer of its forward: ``rows`` holds (got [V], want [V], got layers,
    want layers, label), a layer being (capture, token index). A row is
    compared where the token's top-k sets and kept assignments agree in
    every layer. A differing top-k set (a routing flip: a ~1e-6 difference
    upstream moves a near-tie at the k-th expert, and the token's output by
    O(1)) must be a near-tie of ``want``'s scores (within ROUTING_TIE) in
    the first layer where the sets differ (later layers see the changed
    output); kept assignments that differ with equal sets (capacity, or a
    flip earlier in the forward, moved the ranks) are counted. Returns
    (max |d| over compared rows, flips, rows with other drops)."""
    worst, flips, drops = 0.0, 0, 0
    for got, want, g_layers, w_layers, label in rows:
        check(bool(torch.isfinite(got).all()), f"{what} {label}: logits not finite")
        flipped = kept_differs = False
        for (g, gt), (w, wt) in zip(g_layers, w_layers):
            if not torch.equal(g["ids"][gt], w["ids"][wt]):
                gap = float(w["gap"][wt])
                check(gap <= ROUTING_TIE, f"{what} {label}: top-k experts differ "
                      f"(k-th minus (k+1)-th score {gap:.3g} > {ROUTING_TIE})")
                flipped = True
                break
            if not torch.equal(g["kept"][gt], w["kept"][wt]):
                kept_differs = True
                break
        if flipped or kept_differs:
            flips += flipped
            drops += not flipped
            continue
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=tol, rtol=tol),
              f"{what} {label}: max |d| {err:.3g} > tol {tol}")
        worst = max(worst, err)
    return worst, flips, drops


def ds_serve(cfg) -> tuple[int, float]:
    """deepseek-moe-16b at full width and depth: serve, check, time;
    returns the flash launches of the serving run and the largest
    |kernel - plain| on its prefill activations."""
    spec = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = spec.init(0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = spec.param_count(params)
    rng = np.random.default_rng(14)
    queue = [rng.integers(1, cfg.vocab, size=SERVE_PROMPT) for _ in range(SERVE_REQUESTS)]
    prompts = np.stack(queue[:SERVE_BATCH])
    zero_flash_counts()
    batches, serve_s = serve_requests(spec, params, queue)
    launches, tc = flash_attention.launches, flash_attention.tensor_core_launches
    need = cfg.num_layers * len(batches)
    log(f"  {DS_ARCH}: {n_params / 1e9:.3f} B params ({n_params * 2 / 1e9:.1f} GB bf16, "
        f"made in {init_s:.1f} s), {SERVE_REQUESTS} requests in {len(batches)} batches "
        f"of {SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_GEN} generated tokens each; "
        f"flash launches {launches}, {tc} on the tensor-core forward")
    check(launches >= need and tc == launches,
          f"the serving path launched flash {launches} times ({tc} tensor-core), not "
          f">= {cfg.num_layers} per batch, all tensor-core")
    for toks in batches:
        check(toks.shape == (SERVE_BATCH, SERVE_GEN)
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"served tokens {toks.shape} out of shape or vocab")
    n_tokens = SERVE_REQUESTS * SERVE_GEN
    prefill_ms, decode_ms = time_serve_steps(spec, params, prompts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"  served {n_tokens} tokens in {serve_s:.3f} s ({n_tokens / serve_s:.1f} tok/s); "
        f"prefill {prefill_ms:.2f} ms per batch of {SERVE_BATCH} x {SERVE_PROMPT}, decode "
        f"{decode_ms:.2f} ms per step; peak device memory {peak_gib:.2f} GiB")
    tokens = torch.as_tensor(prompts, device="cuda")
    with captured_routing() as seen:
        first = spec.prefill(params, tokens, SERVE_CACHE_LEN)[0]
    second = spec.prefill(params, tokens, SERVE_CACHE_LEN)[0]
    check(torch.equal(first, second), "two prefills of one batch gave different logits")
    log(f"  two prefills of one batch: identical logits; {dropped(seen)} of "
        f"{sum(c['kept'].numel() for c in seen)} expert assignments past capacity "
        f"({len(seen)} MoE layers)")
    del seen, first, second
    err = check_prefill_activations(spec, params, prompts)
    return launches, err


def ds_f32(cfg) -> None:
    """Full width, 2 layers (1 dense + 1 MoE), f32: prefill and 8
    teacher-forced decode steps through the kernel path against the plain
    attention path, with the routing-flip rule."""
    cfg32 = dataclasses.replace(cfg, num_layers=DS_F32_LAYERS, dtype=torch.float32)
    spec = build_model(cfg32)
    params = spec.init(0, "cuda")
    rng = np.random.default_rng(15)
    prompts = rng.integers(1, cfg.vocab, size=(SERVE_BATCH, SERVE_PROMPT))
    forced = rng.integers(1, cfg.vocab, size=(SERVE_BATCH, DS_F32_STEPS))
    with captured_routing() as g_seen:
        got = teacher_forced_logits(spec, params, prompts, forced)
    with plain_attention(), captured_routing() as w_seen:
        want = teacher_forced_logits(spec, params, prompts, forced)
    n_moe = DS_F32_LAYERS - cfg.num_dense_layers
    rows = []
    for step, (a, b) in enumerate(zip(got, want)):
        g, w = g_seen[step * n_moe:(step + 1) * n_moe], w_seen[step * n_moe:(step + 1) * n_moe]
        for r in range(SERVE_BATCH):
            t = r * SERVE_PROMPT + SERVE_PROMPT - 1 if step == 0 else r
            label = "prefill" if step == 0 else f"decode step {step}"
            rows.append((a[r], b[r], [(c, t) for c in g], [(c, t) for c in w],
                         f"{label} row {r}"))
    worst, flips, drops = compare_rows(rows, SERVE_F32_TOL, "f32 2-layer")
    log(f"  f32 full width, {DS_F32_LAYERS} layers: prefill and {DS_F32_STEPS} teacher-forced "
        f"decode steps, kernel path vs plain attention: max |d| {worst:.3g} over "
        f"{len(rows) - flips - drops} of {len(rows)} rows (tol {SERVE_F32_TOL}); "
        f"{flips} routing flips at near-ties, {drops} rows with other kept assignments; "
        f"prefill drops {dropped(g_seen[:n_moe])} kernel path, {dropped(w_seen[:n_moe])} plain")


def ds_train(cfg) -> tuple[int, int]:
    """Full width, 4 layers (1 dense + 3 MoE), bf16, remat: 4 steps of 4 x
    2048 through make_state / make_step / run_training; returns the flash
    forward and backward launches of the run."""
    cfgt = dataclasses.replace(cfg, num_layers=DS_TRAIN_LAYERS)
    spec = build_model(cfgt)
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=DS_TRAIN_STEPS,
                          warmup_steps=max(10, DS_TRAIN_STEPS // 20))
    data = SyntheticLM(cfgt, DS_TRAIN_BATCH, TRAIN_SEQ, seed=0)
    state = make_state(spec, opt_cfg, 0, compression=False, device="cuda")
    n_params = spec.param_count(state["params"])
    step = make_step(spec, opt_cfg, compression=False)
    times, metrics = [], []

    def timed(st, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, m = step(st, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        return new, m

    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(dir=ROOT / "build", prefix="chip_smoke_ds_ckpt_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_flash_counts()
        t0 = time.perf_counter()
        state, report = run_training(
            timed, state, lambda i: data.batch_at(i, "cuda"), DS_TRAIN_STEPS,
            FaultConfig(ckpt_dir=ckpt_dir, ckpt_every=DS_TRAIN_STEPS))
        run_s = time.perf_counter() - t0
        counts = flash_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(report.restarts == 0 and report.steps_done == DS_TRAIN_STEPS,
          f"training: {report.steps_done} steps, {report.restarts} restarts")
    for i, m in enumerate(metrics):
        check(np.isfinite(m["loss"]) and m["aux"] > 0
              and abs(m["loss"] - (m["ce"] + m["aux"])) <= 1e-6 * max(1.0, abs(m["loss"])),
              f"step {i + 1}: loss {m['loss']}, ce {m['ce']}, aux {m['aux']}: not finite, "
              "aux not > 0 or not inside the loss")
    check_counts(counts, DS_TRAIN_STEPS, cfgt.num_layers, "deepseek training")
    fwd, tc, bwd, tc_bwd = counts
    check(tc_bwd == bwd, f"deepseek training: {bwd} backward launches, {tc_bwd} tensor-core")
    ms = statistics.median(times[1:]) * 1e3
    tokens = DS_TRAIN_BATCH * TRAIN_SEQ
    log(f"  {DS_ARCH} at {DS_TRAIN_LAYERS} layers ({cfgt.num_dense_layers} dense + "
        f"{DS_TRAIN_LAYERS - cfgt.num_dense_layers} MoE): {n_params / 1e9:.3f} B params, "
        f"{DS_TRAIN_STEPS} steps of {DS_TRAIN_BATCH} x {TRAIN_SEQ}, bf16, remat")
    log("  losses " + ", ".join(f"{m['loss']:.4f} (ce {m['ce']:.4f} + aux {m['aux']:.5f})"
                                for m in metrics))
    log(f"  flash launches: forward {fwd}, tensor-core {tc}, backward {bwd}, tensor-core "
        f"backward {tc_bwd}; step times {', '.join(f'{t * 1e3:.1f}' for t in times)} ms, "
        f"median of steps 2-{DS_TRAIN_STEPS} {ms:.2f} ms/step ({tokens / ms * 1e3:.0f} "
        f"tokens/s); run {run_s:.1f} s with the last step's checkpoint; peak device "
        f"memory {peak_gib:.2f} GiB")
    return fwd, bwd


def v3_check() -> None:
    """deepseek-v3-671b at full width, 4 layers (3 dense + 1 MoE of 256
    experts): serve 4 requests in bf16; then, in f32 at batch 1, prefill
    and teacher-forced decode against one parallel forward at the same
    positions."""
    cfg = dataclasses.replace(get_config(V3_ARCH), num_layers=V3_LAYERS)
    m, mla = cfg.moe, cfg.mla
    check((cfg.d_model, cfg.num_heads, cfg.vocab, cfg.num_dense_layers, m.num_experts,
           m.top_k, m.num_shared, m.score_fn, mla.q_lora, mla.kv_lora, mla.rope_dim,
           mla.qk_nope_dim, mla.v_dim, cfg.moe_d_ff, cfg.d_ff, cfg.mtp)
          == (7168, 128, 129280, 3, 256, 8, 1, "sigmoid", 1536, 512, 64, 128, 128,
              2048, 18432, True), f"{V3_ARCH} is not at full width")
    spec = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = spec.init(0, "cuda")
    n_params = spec.param_count(params)
    rng = np.random.default_rng(16)
    prompts = rng.integers(1, cfg.vocab, size=(V3_REQUESTS, SERVE_PROMPT))
    zero_flash_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with captured_routing() as seen:
        tokens = serve_batch(spec, params, prompts, V3_GEN, SERVE_CACHE_LEN)
    serve_s = time.perf_counter() - t0
    check(tokens.shape == (V3_REQUESTS, V3_GEN)
          and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()), "v3 tokens out of range")
    check(flash_attention.launches == 0, "MLA launched the flash kernel")
    n_moe = cfg.num_layers - cfg.num_dense_layers
    prefill_ms, decode_ms = time_serve_steps(spec, params, prompts, V3_GEN)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {V3_ARCH} at {V3_LAYERS} layers: {n_params / 1e9:.3f} B params "
        f"({n_params * 2 / 1e9:.1f} GB bf16); {V3_REQUESTS} requests, prompt {SERVE_PROMPT}, "
        f"{V3_GEN} tokens in {serve_s:.3f} s; prefill {prefill_ms:.2f} ms, decode "
        f"{decode_ms:.2f} ms per step; prefill drops {dropped(seen[:n_moe])} of "
        f"{sum(c['kept'].numel() for c in seen[:n_moe])} assignments; peak device "
        f"memory {peak_gib:.2f} GiB")
    del params, seen
    torch.cuda.empty_cache()

    # f32, batch 1: the MTP head is left out (serving never runs it)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, mtp=False)
    spec32 = build_model(cfg32)
    params = spec32.init(0, "cuda")
    prompt, forced = prompts[:1], tokens[:1, :V3_GEN - 1]
    with captured_routing(inputs=True) as cached:
        got = teacher_forced_logits(spec32, params, prompt, forced)
    full = torch.as_tensor(np.concatenate([prompt, forced], axis=1), device="cuda")
    with captured_routing(inputs=True) as parallel:
        x, _, _ = lm.lm_forward(params, cfg32, full)
        want = lm._unembed(params, cfg32, x[:, SERVE_PROMPT - 1:])[0]
    del x
    rows = [(a[0], want[i],
             [(c, SERVE_PROMPT - 1 if i == 0 else 0) for c in cached[i * n_moe:(i + 1) * n_moe]],
             [(c, SERVE_PROMPT - 1 + i) for c in parallel],
             "prefill" if i == 0 else f"decode step {i}") for i, a in enumerate(got)]
    worst, flips, drops = compare_rows(rows, V3_TOL, "v3 f32")
    # what reaches the first MoE router (the dense layers and MLA through
    # its cache) at every position, whatever the capacity dropped: later
    # layers attend over positions whose drops differed
    x_worst = 0.0
    for _, _, ((g, gt), *_), ((w, wt), *_), label in rows:
        err = float((g["x"][gt] - w["x"][wt]).abs().max())
        check(torch.allclose(g["x"][gt], w["x"][wt], atol=V3_TOL, rtol=V3_TOL),
              f"v3 f32 {label}: router input max |d| {err:.3g} > tol {V3_TOL}")
        x_worst = max(x_worst, err)
    log(f"  f32, batch 1: the first MoE router's input at all {len(rows)} positions, "
        f"cached path vs parallel forward: max |d| {x_worst:.3g} (tol {V3_TOL})")
    log(f"  f32, batch 1: prefill and {V3_GEN - 1} decode steps vs one parallel forward of "
        f"{full.shape[1]} tokens: max |d| {worst:.3g} over {len(rows) - flips - drops} of "
        f"{len(rows)} positions (tol {V3_TOL}); {flips} routing flips at near-ties, {drops} "
        f"positions whose kept assignments differ (drops: prefill {dropped(cached[:n_moe])}, "
        f"parallel forward {dropped(parallel)})")


def free_device(after: str) -> None:
    """Free what the last model left (reference cycles included) before the
    next one, and say how much stays allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  after {after}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
        f"script wall {time.perf_counter() - T_START:.1f} s")


def phase_deepseek() -> tuple[int, int, float]:
    """The DeepSeek family (see the module docstring, item 14). Returns the
    flash forward and backward launches of the phase and the largest
    |kernel - plain| on the model's activations."""
    t_phase = time.perf_counter()
    cfg = get_config(DS_ARCH)
    m = cfg.moe
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
           cfg.d_ff, cfg.moe_d_ff, cfg.vocab, cfg.num_dense_layers, m.num_experts,
           m.top_k, m.num_shared, m.score_fn, cfg.dtype)
          == (28, 2048, 16, 16, 128, 10944, 1408, 102400, 1, 64, 6, 2, "softmax",
              torch.bfloat16), f"{DS_ARCH} is not at full width and depth")
    serve_launches, err = ds_serve(cfg)
    free_device("serving")
    phase_flash_timing(DS_SHAPE, f"{DS_ARCH} prefill shape", f32=False)
    ds_f32(cfg)
    free_device("f32 check")
    fwd, bwd = ds_train(cfg)
    free_device("training")
    v3_check()
    free_device(V3_ARCH)
    log(f"  phase 14 flash launches: forward {serve_launches + fwd} (serving "
        f"{serve_launches}, training {fwd}), backward {bwd}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return serve_launches + fwd, bwd, err


# ----------------------------------------------------------------- phase 15

def family_serve(cfg, seed: int, prompt: int = SERVE_PROMPT,
                 profile_prefill: bool = True) -> dict:
    """Serve SERVE_REQUESTS prompts of ``prompt`` tokens in batches through
    ``serve_batch``, time one batch's prefill and decode, profile them (the
    prefill only with ``profile_prefill``), and check that two prefills of
    one batch give the same logits. Returns the
    model, its parameter count, the first batch's prompts, and the flash
    launches of the serving run and of one prefill (with their tensor-core
    share)."""
    spec = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = spec.init(0, "cuda")
    n_params = spec.param_count(params)
    rng = np.random.default_rng(seed)
    queue = [rng.integers(1, cfg.vocab, size=prompt) for _ in range(SERVE_REQUESTS)]
    prompts = np.stack(queue[:SERVE_BATCH])
    zero_flash_counts()
    batches, serve_s = serve_requests(spec, params, queue)
    launches, tc = flash_attention.launches, flash_attention.tensor_core_launches
    for toks in batches:
        check(toks.shape == (SERVE_BATCH, SERVE_GEN)
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"{cfg.name}: served tokens {toks.shape} out of shape or vocab")
    n_tokens = SERVE_REQUESTS * SERVE_GEN
    prefill_ms, decode_ms = time_serve_steps(spec, params, prompts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {cfg.name}: {n_params / 1e6:.3f} M params ({n_params * 2 / 1e9:.3f} GB bf16), "
        f"{SERVE_REQUESTS} requests in {len(batches)} batches of {SERVE_BATCH}, prompt "
        f"{prompt}, {SERVE_GEN} generated tokens each; flash launches {launches}, "
        f"{tc} on the tensor-core forward")
    log(f"  served {n_tokens} tokens in {serve_s:.3f} s ({n_tokens / serve_s:.1f} tok/s); "
        f"prefill {prefill_ms:.2f} ms per batch of {SERVE_BATCH} x {prompt}, decode "
        f"{decode_ms:.2f} ms per step; peak device memory {peak_gib:.2f} GiB")
    t0 = time.perf_counter()
    profile_serve(spec, params, prompts, prefill=profile_prefill)
    log(f"  (the profiles took {time.perf_counter() - t0:.1f} s with their processing)")
    batch = prefill_input(spec, prompts)
    zero_flash_counts()
    first = spec.prefill(params, batch, cache_len_for(prompt))[0]
    one, one_tc = flash_attention.launches, flash_attention.tensor_core_launches
    second = spec.prefill(params, batch, cache_len_for(prompt))[0]
    check(torch.equal(first, second), f"{cfg.name}: two prefills of one batch gave "
          "different logits")
    log(f"  two prefills of one batch: identical logits; one prefill launched flash "
        f"{one} times, {one_tc} on the tensor-core forward")
    return dict(spec=spec, params=params, n_params=n_params, launches=launches, tc=tc,
                batches=len(batches), one=one, one_tc=one_tc, prompts=prompts)


def carried_logits(spec, params, prompt: np.ndarray):
    """(a prefill of ``prompt`` less its last token, then one decode step of
    that token; a prefill of the whole ``prompt``): the two paths' logits."""
    s = prompt.shape[1] - 1
    _, caches = spec.prefill(params, torch.as_tensor(prompt[:, :-1], device="cuda"),
                             SERVE_CACHE_LEN)
    got, _ = spec.decode_step(params, torch.as_tensor(prompt[:, -1:], device="cuda"),
                              caches, s + spec.cfg.num_meta_tokens)
    del caches
    want, _ = spec.prefill(params, torch.as_tensor(prompt, device="cuda"), SERVE_CACHE_LEN)
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()),
          f"{spec.cfg.name} f32: non-finite logits")
    return got, want


def carry_check(spec, params, prompt: np.ndarray) -> float:
    """The two paths of :func:`carried_logits` within SSM_F32_TOL; returns
    max |d|."""
    got, want = carried_logits(spec, params, prompt)
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, atol=SSM_F32_TOL, rtol=SSM_F32_TOL),
          f"{spec.cfg.name} f32: prefill of {prompt.shape[1] - 1} + one decode step != a "
          f"prefill one token longer (max |d| {err:.3g}, tol {SSM_F32_TOL})")
    return err


def rounding_floor(spec, params, prompt: np.ndarray) -> float:
    """How far f32 rounding alone moves the last logits of a prefill of
    ``prompt``: max |d| between the prefill and the same prefill with every
    embedding entry moved by one ulp. xLSTM's random-weight recurrence
    amplifies such a change ~1e5-fold over 2048 steps (the JAX package's
    alike), so two paths that round differently anywhere in a long prefix
    differ by this much whatever they carry."""
    tokens = torch.as_tensor(prompt, device="cuda")
    want = spec.prefill(params, tokens, SERVE_CACHE_LEN)[0]
    moved = dict(params, embed=torch.nextafter(params["embed"],
                                               torch.full_like(params["embed"], torch.inf)))
    got = spec.prefill(moved, tokens, SERVE_CACHE_LEN)[0]
    return float((got - want).abs().max())


def family_f32(cfg, seed: int) -> None:
    """f32 at full width and depth, batch 1: for hymba, the prefill logits
    of the kernel path against the plain-attention path; then the state
    carry (:func:`carry_check`; xLSTM's against its rounding floor over the
    full prompt)."""
    spec = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    params = spec.init(0, "cuda")
    prompt = np.random.default_rng(seed).integers(1, cfg.vocab, size=(1, SERVE_PROMPT + 1))
    if cfg.family == "hybrid":
        tokens = torch.as_tensor(prompt[:, :-1], device="cuda")
        zero_flash_counts()
        got = spec.prefill(params, tokens, SERVE_CACHE_LEN)[0]
        check(flash_attention.launches == cfg.num_layers
              and flash_attention.tensor_core_launches == 0,
              f"{cfg.name} f32 prefill: {flash_attention.launches} flash launches "
              f"({flash_attention.tensor_core_launches} tensor-core), not "
              f"{cfg.num_layers} on CUDA cores")
        with plain_attention():
            want = spec.prefill(params, tokens, SERVE_CACHE_LEN)[0]
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all())
              and torch.allclose(got, want, atol=SSM_F32_TOL, rtol=SSM_F32_TOL),
              f"{cfg.name} f32 prefill: kernel path != plain-attention path "
              f"(max |d| {err:.3g}, tol {SSM_F32_TOL})")
        log(f"  f32 full width and depth, batch 1 x {SERVE_PROMPT}: prefill logits, kernel "
            f"path vs plain attention, max |d| {err:.3g} (tol {SSM_F32_TOL}, logits max |x| "
            f"{float(got.abs().max()):.3g})")
        err = carry_check(spec, params, prompt)
        log(f"  f32 full width and depth, batch 1: prefill of {SERVE_PROMPT} + one decode step "
            f"vs a prefill of {SERVE_PROMPT + 1}: logits max |d| {err:.3g} (tol {SSM_F32_TOL})")
        return
    # xLSTM: the carry within SSM_F32_TOL over a prompt short enough that
    # rounding is not amplified past it; over the full prompt, within
    # CARRY_FLOOR_FACTOR of the rounding floor measured on the same prompt
    err = carry_check(spec, params, prompt[:, :XL_CARRY_PROMPT + 1])
    log(f"  f32 full width and depth, batch 1: prefill of {XL_CARRY_PROMPT} + one decode step "
        f"vs a prefill of {XL_CARRY_PROMPT + 1}: logits max |d| {err:.3g} (tol {SSM_F32_TOL})")
    got, want = carried_logits(spec, params, prompt)
    err = float((got - want).abs().max())
    floor = rounding_floor(spec, params, prompt)
    check(err <= CARRY_FLOOR_FACTOR * floor,
          f"{cfg.name} f32: prefill of {SERVE_PROMPT} + one decode step vs a prefill of "
          f"{SERVE_PROMPT + 1}: max |d| {err:.3g} > {CARRY_FLOOR_FACTOR} x the rounding "
          f"floor {floor:.3g}")
    log(f"  f32 full width and depth, batch 1: prefill of {SERVE_PROMPT} + one decode step vs "
        f"a prefill of {SERVE_PROMPT + 1}: logits max |d| {err:.3g}; one ulp on every "
        f"embedding moves the same prefill's logits by {floor:.3g} (gate: {CARRY_FLOOR_FACTOR}x "
        f"that; a lost or misplaced state moves them by O(1))")


def predicted_peak_gib(cfg, batch: int, seq: int) -> float:
    """The training step's peak device memory as the dry-run counts it
    (``roofline.analysis.measure_step`` of make_state / make_step on meta
    tensors: the state, then every live intermediate), in GiB."""
    from repro_torch.roofline.analysis import measure_step

    spec = build_model(cfg)
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=2, warmup_steps=10)
    state = make_state(spec, opt_cfg, 0, compression=False, device="meta")
    tokens = torch.zeros((batch, seq), dtype=torch.int64, device="meta")
    counts = measure_step(make_step(spec, opt_cfg, compression=False), state,
                          {"tokens": tokens, "labels": tokens})
    return counts.peak_bytes / 2**30


def family_train(cfg, steps: int, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                 profile: bool | None = None) -> tuple:
    """``steps`` of ``batch`` x ``seq`` (a vlm's batch with its prefix
    embeddings, an audio model's with its frames) through make_state /
    make_step (AdamW at the training CLI's defaults, bf16, remat), then,
    with ``profile`` (default: for hymba), one more step under
    torch.profiler (an xLSTM step is ~1,000,000 launches); returns the
    flash launch counts of the ``steps`` (forward, tensor-core, backward,
    tensor-core backward)."""
    spec = build_model(cfg)
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=steps, warmup_steps=max(10, steps // 20))
    data = SyntheticLM(cfg, batch, seq, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = make_state(spec, opt_cfg, 0, compression=False, device="cuda")
    step = make_step(spec, opt_cfg, compression=False)
    zero_flash_counts()
    losses, times = [], []
    for i in range(steps):
        inputs = data.batch_at(i, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    del inputs
    counts = flash_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(losses)), f"{cfg.name} training: non-finite losses {losses}")
    ms = statistics.median(times[1:]) * 1e3
    tokens = batch * seq
    fwd, tc, bwd, tc_bwd = counts
    log(f"  {cfg.name} training: {steps} steps of {batch} x {seq}, bf16, remat, "
        f"AdamW; losses {', '.join(f'{x:.4f}' for x in losses)} (ln vocab "
        f"{np.log(cfg.vocab):.4f}); flash launches forward {fwd}, tensor-core {tc}, backward "
        f"{bwd}, tensor-core backward {tc_bwd}")
    log(f"  step times {', '.join(f'{t * 1e3:.1f}' for t in times)} ms; median of steps "
        f"2-{steps} {ms:.2f} ms/step ({tokens / ms * 1e3:.0f} tokens/s); peak device memory "
        f"{peak_gib:.2f} GiB")
    if cfg.family == "hybrid" if profile is None else profile:
        profile_step(spec, opt_cfg, state, data.batch_at(steps, "cuda"))
    return counts


def phase_ssm_hybrid() -> tuple[int, int, float]:
    """The SSM and hybrid families (see the module docstring, item 15).
    Returns the flash forward and backward launches of the phase's serving
    and training runs and the largest |kernel - plain| on hymba's prefill
    activations."""
    t_phase = time.perf_counter()
    cfg = get_config(HY_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
           cfg.d_ff, cfg.vocab, cfg.sliding_window, cfg.num_meta_tokens, cfg.ssm.state_dim,
           cfg.ssm.chunk, cfg.dtype, cfg.remat)
          == (32, 1600, 25, 5, 64, 5504, 32001, HY_WINDOW, 128, 16, 128, torch.bfloat16,
              True), f"{HY_ARCH} is not at full width and depth")
    windows = lm.layer_windows(cfg, cfg.num_layers)
    check([i for i, w in enumerate(windows) if not w] == [0, 16, 31]
          and set(windows.tolist()) == {0, HY_WINDOW}, f"{HY_ARCH} windows {windows}")
    run = family_serve(cfg, seed=17)
    check(run["n_params"] == HY_PARAMS, f"{HY_ARCH}: {run['n_params']} params")
    check(run["launches"] == cfg.num_layers * run["batches"] and run["tc"] == run["launches"]
          and run["one"] == run["one_tc"] == cfg.num_layers,
          f"{HY_ARCH} serving: flash launches {run['launches']} ({run['tc']} tensor-core), "
          f"one prefill {run['one']} ({run['one_tc']}); want {cfg.num_layers} a prefill, "
          "all tensor-core")
    hy_err = check_prefill_activations(run["spec"], run["params"], run["prompts"],
                                       (0, 1, cfg.num_layers - 1))
    serve_launches = run["launches"]
    del run
    free_device(f"{HY_ARCH} serving")
    for window in (HY_WINDOW, None):
        phase_flash_timing(HY_SHAPE, f"{HY_ARCH} prefill shape", f32=False, window=window)
    family_f32(cfg, seed=18)
    free_device(f"{HY_ARCH} f32 checks")
    fwd, tc, bwd, tc_bwd = family_train(cfg, HY_TRAIN_STEPS)
    # remat: each layer's forward runs twice a step (the pass and the recompute)
    want = (2 * cfg.num_layers * HY_TRAIN_STEPS, cfg.num_layers * HY_TRAIN_STEPS)
    check((fwd, bwd) == want and tc == fwd and tc_bwd == bwd,
          f"{HY_ARCH} training: flash forward {fwd} ({tc} tensor-core), backward {bwd} "
          f"({tc_bwd} tensor-core); want {want[0]} and {want[1]}, all tensor-core")
    free_device(f"{HY_ARCH} training")

    cfg = get_config(XL_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff, cfg.vocab, cfg.ssm.chunk,
           cfg.dtype, cfg.remat) == (12, 768, 4, 0, 50304, 128, torch.bfloat16, True),
          f"{XL_ARCH} is not at full width and depth")
    # no profile of xlstm's prefill: its ~248,000 launches take ~40 s to
    # trace and sort, and PRs 20-23 recorded its breakdown (host-bound)
    run = family_serve(cfg, seed=19, prompt=XL_PROMPT, profile_prefill=False)
    check(run["n_params"] == XL_PARAMS, f"{XL_ARCH}: {run['n_params']} params")
    check(run["launches"] == run["one"] == 0, f"{XL_ARCH} launched flash attention")
    del run
    free_device(f"{XL_ARCH} serving")
    family_f32(cfg, seed=20)
    free_device(f"{XL_ARCH} f32 check")
    xl_counts = family_train(dataclasses.replace(cfg, num_layers=XL_TRAIN_LAYERS),
                             XL_TRAIN_STEPS)
    check(xl_counts == (0, 0, 0, 0), f"{XL_ARCH} training launched flash attention")
    free_device(f"{XL_ARCH} training")
    log(f"  phase 15 flash launches: forward {serve_launches + fwd} (serving "
        f"{serve_launches}, training {fwd}), backward {bwd}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return serve_launches + fwd, bwd, hy_err


# ----------------------------------------------------------------- phase 16

def f32_parity(cfg, seed: int, prompt: int, steps: int, frames: bool = False) -> float:
    """f32 at batch 1: prefill and ``steps`` teacher-forced decode steps
    (at ``serve_batch``'s positions) through the kernel path against the
    plain-attention path, within SERVE_F32_TOL; the kernel path's prefill
    launches flash once per layer, on the CUDA-core kernel. ``frames``:
    random frame embeddings from the seed for an audio model (else what
    ``serve_batch`` gives). Returns the largest |d|."""
    spec = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    params = spec.init(0, "cuda")
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab, size=(1, prompt))
    forced = rng.integers(1, cfg.vocab, size=(1, steps))
    f = (torch.as_tensor(rng.standard_normal((1, cfg.frontend_len, cfg.d_model))
                         .astype(np.float32) * 0.1, device="cuda") if frames else None)
    zero_flash_counts()
    got = teacher_forced_logits(spec, params, prompts, forced, f)
    check(flash_attention.launches == cfg.num_layers
          and flash_attention.tensor_core_launches == 0,
          f"{cfg.name} f32: {flash_attention.launches} flash launches "
          f"({flash_attention.tensor_core_launches} tensor-core), not {cfg.num_layers} "
          "on CUDA cores")
    with plain_attention():
        want = teacher_forced_logits(spec, params, prompts, forced, f)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    for i, (a, b) in enumerate(zip(got, want)):
        what = "prefill" if i == 0 else f"decode step {i} (position {decode_pos(spec, i - 1, prompt)})"
        check(a.shape == (1, cfg.vocab) and bool(torch.isfinite(a).all())
              and torch.allclose(a, b, atol=SERVE_F32_TOL, rtol=SERVE_F32_TOL),
              f"{cfg.name} f32 {what}: kernel path != plain-attention path "
              f"(max |d| {errs[i]:.3g}, tol {SERVE_F32_TOL})")
    log(f"  f32, {cfg.num_layers} layers, batch 1 x {prompt}: prefill logits max |d| "
        f"{errs[0]:.3g}, {steps} teacher-forced decode steps (positions "
        f"{decode_pos(spec, 0, prompt)}-{decode_pos(spec, steps - 1, prompt)}, cache "
        f"{cache_len_for(prompt)}) max |d| {max(errs[1:]):.3g}, kernel path vs plain "
        f"attention (tol {SERVE_F32_TOL}, logits max |x| {float(got[0].abs().max()):.3g})")
    return max(errs)


def phase_vlm_audio() -> tuple[int, int, float, float]:
    """The vision-language and audio families (see the module docstring,
    item 16). Returns the flash forward and backward launches of the
    phase's serving and training runs, and the largest |kernel - plain| of
    the forward (on the models' prefill and whisper's training activations)
    and of the backward (on whisper's training activations)."""
    t_phase = time.perf_counter()
    cfg = get_config(PG_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
           cfg.d_ff, cfg.vocab, cfg.mlp_kind, cfg.tie_embeddings, cfg.embed_scale,
           cfg.prefix_lm, cfg.frontend, cfg.frontend_len, cfg.dtype, cfg.remat)
          == (18, 2048, 8, 1, 256, 16384, 257216, "geglu", True, True, True, "vision", 256,
              torch.bfloat16, True), f"{PG_ARCH} is not at full width and depth")
    run = family_serve(cfg, seed=21)
    spec = run["spec"]
    check(run["n_params"] == PG_PARAMS, f"{PG_ARCH}: {run['n_params']} params")
    check(run["launches"] == cfg.num_layers * run["batches"] and run["tc"] == run["launches"]
          and run["one"] == run["one_tc"] == cfg.num_layers,
          f"{PG_ARCH} serving: flash launches {run['launches']} ({run['tc']} tensor-core), "
          f"one prefill {run['one']} ({run['one_tc']}); want {cfg.num_layers} a prefill, "
          "all tensor-core")
    first = decode_pos(spec, 0)
    check(first >= SERVE_CACHE_LEN - 1, f"{PG_ARCH}: decode from position {first} does not "
          f"run past the cache of {SERVE_CACHE_LEN}")
    log(f"  decode positions {first}-{decode_pos(spec, SERVE_GEN - 2)} in a cache of "
        f"{SERVE_CACHE_LEN}: every write clamped into slot {SERVE_CACHE_LEN - 1}, as the "
        "reference's dynamic_update_slice does")
    pg_err = check_prefill_activations(spec, run["params"], run["prompts"],
                                       (0, cfg.num_layers - 1))
    serve_launches = run["launches"]
    del run, spec
    free_device(f"{PG_ARCH} serving")
    phase_flash_timing(PG_SHAPE, f"{PG_ARCH} prefill shape", f32=False)
    f32_parity(dataclasses.replace(cfg, num_layers=PG_F32_LAYERS), 22, SERVE_PROMPT,
               PG_F32_STEPS)
    free_device(f"{PG_ARCH} f32 check")
    counts = family_train(cfg, PG_TRAIN_STEPS, batch=PG_TRAIN_BATCH)
    check(counts == (0, 0, 0, 0), f"{PG_ARCH} training (prefix-LM) launched flash "
          f"attention: {counts}")
    free_device(f"{PG_ARCH} training")

    cfg = get_config(WH_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
           cfg.d_ff, cfg.vocab, cfg.mlp_kind, cfg.use_rope, cfg.frontend, cfg.frontend_len,
           cfg.dtype, cfg.remat)
          == (12, 768, 12, 12, 64, 3072, 51865, "gelu", False, "audio", 1500,
              torch.bfloat16, True), f"{WH_ARCH} is not at full width and depth")
    run = family_serve(cfg, seed=23, prompt=WH_PROMPT)
    check(run["n_params"] == WH_PARAMS, f"{WH_ARCH}: {run['n_params']} params")
    check(run["launches"] == cfg.num_layers * run["batches"] and run["tc"] == run["launches"]
          and run["one"] == run["one_tc"] == cfg.num_layers,
          f"{WH_ARCH} serving: flash launches {run['launches']} ({run['tc']} tensor-core), "
          f"one prefill {run['one']} ({run['one_tc']}); want {cfg.num_layers} a prefill "
          "(the decoder's self-attention), all tensor-core")
    wh_err = check_prefill_activations(run["spec"], run["params"], run["prompts"],
                                       (0, cfg.num_layers - 1))
    serve_launches += run["launches"]
    del run
    free_device(f"{WH_ARCH} serving")
    phase_flash_timing(WH_SHAPE, f"{WH_ARCH} decoder prefill shape ({WH_PROMPT} padded)",
                       f32=False)
    f32_parity(cfg, 24, WH_PROMPT, WH_F32_STEPS, frames=True)
    free_device(f"{WH_ARCH} f32 check")
    fwd, tc, bwd, tc_bwd = family_train(cfg, WH_TRAIN_STEPS, seq=WH_TRAIN_SEQ)
    # remat: each decoder layer's forward runs twice a step (the pass and
    # the recompute); the encoder's bidirectional attention stays off flash
    want = (2 * cfg.num_layers * WH_TRAIN_STEPS, cfg.num_layers * WH_TRAIN_STEPS)
    check((fwd, bwd) == want and tc == fwd and tc_bwd == bwd,
          f"{WH_ARCH} training: flash forward {fwd} ({tc} tensor-core), backward {bwd} "
          f"({tc_bwd} tensor-core); want {want[0]} and {want[1]}, all tensor-core")
    free_device(f"{WH_ARCH} training")
    # the kernels at the training step's own shape (448 rows padded to 512):
    # decoder layers 0 and 11's q, k, v and d out, through the padded path
    wh_bwd_err = 0.0
    for label, q, k, v, do, kw in training_activations(WH_ARCH, TRAIN_BATCH, WH_TRAIN_SEQ):
        wh_err = max(wh_err, check_fwd_activations(f"{WH_ARCH} {label}", q, k, v, kw))
        wh_bwd_err = max(wh_bwd_err, check_bwd_case(f"{WH_ARCH} {label}", q, k, v, do,
                                                     dict(kw, padded=True)))
    free_device(f"{WH_ARCH} training activations")
    log(f"  phase 16 flash launches: forward {serve_launches + fwd} (serving "
        f"{serve_launches}, training {fwd}), backward {bwd}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return serve_launches + fwd, bwd, max(pg_err, wh_err), wh_bwd_err


# ----------------------------------------------------------------- phase 17

def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_cfg(arch: str, layers: int | None):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def sharded_opt_cfg() -> AdamWConfig:
    # phase 10's: the training CLI's defaults for its 8 steps
    return AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                       warmup_steps=max(10, TRAIN_STEPS // 20))


def sharded_run(cfg, mesh, batch: int, steps: int, *, keep_init: bool = False) -> dict:
    """``steps`` of ``make_sharded_step`` on this rank's shards of ``mesh``
    from seed 0 (phase 10's state) and batches 0.. of ``batch`` x 2048:
    the placed state, global losses and grad norms, per-step times, flash
    launch counts and peak memory; with ``keep_init``, this rank's initial
    parameter shards (f32, on the host) by path."""
    device = mesh_device(mesh)
    params = build_model(cfg).init(0, device)
    spec = build_model(cfg, mesh=mesh)
    p_sh = param_shardings(params, mesh)
    o_sh = build_opt_shardings(params, p_sh, mesh)
    data = SyntheticLM(cfg, batch, TRAIN_SEQ, seed=0)
    b_sh = batch_shardings(data.host_batch(0), mesh, ("data",))
    opt_cfg = sharded_opt_cfg()
    state = make_sharded_state(opt_cfg, params, p_sh, o_sh, compression=False)
    del params
    init = ({p: d.to_local().float().cpu() for p, d in leaves_with_paths(state["params"])}
            if keep_init else None)
    step = make_sharded_step(spec, opt_cfg, mesh, p_sh, o_sh, b_sh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts()
    losses, norms, times = [], [], []
    for i in range(steps):
        inputs = data.batch_at(i, shardings=b_sh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(state=state, init=init, losses=losses, norms=norms, times=times,
                counts=flash_counts(), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                p_specs={p: sh.spec for p, sh in leaves_with_paths(p_sh)})


def plain_run(cfg, batch: int, steps: int) -> dict:
    """The same steps through make_state / make_step on one device."""
    spec = build_model(cfg)
    opt_cfg = sharded_opt_cfg()
    data = SyntheticLM(cfg, batch, TRAIN_SEQ, seed=0)
    state = make_state(spec, opt_cfg, 0, compression=False, device="cuda")
    step = make_step(spec, opt_cfg, compression=False)
    losses, norms, times = [], [], []
    for i in range(steps):
        inputs = data.batch_at(i, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(params=state["params"], losses=losses, norms=norms, times=times)


def leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (0 for an all-zero want equal to got)."""
    d = (got.float() - want.float()).abs().max().item()
    m = want.float().abs().max().item()
    return d / m if m else d


def same_or_close(label: str, got: list, want: list) -> tuple[bool, float]:
    """Whether two lists of numbers are equal, else their worst relative
    difference, which must be within SH_TOL."""
    if got == want:
        return True, 0.0
    err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))
    check(err <= SH_TOL, f"{label}: {got} vs {want} ({err:.3g} > {SH_TOL})")
    return False, err


def save_params(params, path: Path) -> None:
    """Whole parameters (a DTensor gathered) to ``path`` on the host."""
    torch.save({p: full_tensor(t).detach().cpu() for p, t in leaves_with_paths(params)},
               path)


def update_errors(state_params, init: dict, path: Path, spmd) -> dict:
    """Each parameter shard's update on this rank against the one-rank
    run's update of the same slice (its whole final parameters saved at
    ``path``; both runs start from ``init``): ||d - d_1|| / ||d_1||, d the
    final minus the initial shard, in f32 on the host. A shard left
    unchanged reads 1; where d_1 is 0, any d reads inf."""
    want = torch.load(path, map_location="cpu")
    out = {}
    for p, d in leaves_with_paths(state_params):
        w = reshard(want[p].float(), P(), spec_of(d), spmd)   # a slice: no communication
        d_1 = (w - init[p]).norm().item()
        off = (d.to_local().float().cpu() - w).norm().item()
        out[p] = off / d_1 if d_1 else (0.0 if off == 0 else float("inf"))
    return out


def sharded_rank(args: dict) -> None:
    """One rank of phase 17 (b): ``python3 chip_smoke.py --sharded-rank
    <json>``. Joins the gloo group, trains on its shards of the mesh with
    CUDA tensors, holds its final parameter shards against the one-rank
    run's and writes its report as JSON."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{args['port']}",
                            rank=args["rank"], world_size=args["world"],
                            timeout=datetime.timedelta(seconds=SH_RANK_TIMEOUT_S))
    try:
        mesh = make_debug_mesh(*args["mesh"], device_type="cuda")
        if args.get("job") == "serve":
            report = serve_rank(args, mesh)
            dist.barrier()
            Path(args["out"]).write_text(json.dumps(report))
            return
        cfg = sharded_cfg(args["arch"], args["layers"])
        run = sharded_run(cfg, mesh, args["batch"], SH_STEPS, keep_init=True)
        errs = update_errors(run["state"]["params"], run["init"], Path(args["want"]),
                             Spmd(mesh))
        where = max(errs, key=errs.get)
        report = dict(rank=args["rank"], losses=run["losses"], norms=run["norms"],
                      times=run["times"], counts=run["counts"], peak_gib=run["peak_gib"],
                      update_err=errs[where], update_err_leaf=where,
                      update_err_median=statistics.median(errs.values()),
                      update_leaves=len(errs))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    Path(args["out"]).write_text(json.dumps(report))


def run_sharded_ranks(label: str, arch: str, layers, mesh_shape, batch: int,
                      want: Path, out_dir: Path = ROOT / "build" / "phase17",
                      **extra) -> list:
    """Phase 17 (b) and 18 (a): ``mesh_shape`` ranks of this script on the
    one card over gloo; their reports (a rank that fails or outlives
    SH_RANK_TIMEOUT_S fails the phase, every rank killed)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    world = mesh_shape[0] * mesh_shape[1]
    port = free_port()
    procs = []
    for rank in range(world):
        args = dict(rank=rank, world=world, port=port, mesh=list(mesh_shape), arch=arch,
                    layers=layers, batch=batch, want=str(want),
                    out=str(out_dir / f"{label}_rank{rank}.json"), **extra)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-rank",
             json.dumps(args)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failures = []
    try:
        for rank, proc in enumerate(procs):
            try:
                output, _ = proc.communicate(timeout=SH_RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                failures.append(f"rank {rank} outlived {SH_RANK_TIMEOUT_S} s")
                continue
            if proc.returncode:
                failures.append(f"rank {rank} exit {proc.returncode}:\n{output[-4000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(not failures, f"{label}: " + "\n".join(failures))
    return [json.loads((out_dir / f"{label}_rank{r}.json").read_text())
            for r in range(world)]


def check_rank_reports(label: str, reports: list, layers: int, want: dict) -> tuple:
    """Every rank's losses and grad norms (global, the same on every rank)
    within SH_TOL of the one-rank run's, each parameter shard's update
    within SH_UPDATE_TOL of the one-rank run's in norm, >= ``layers``
    tensor-core forward and backward launches a step; returns (forward,
    backward) launches summed over the ranks."""
    fwd = bwd = 0
    for r in reports:
        same_or_close(f"{label} rank {r['rank']} losses", r["losses"], want["losses"])
        same_or_close(f"{label} rank {r['rank']} grad norms", r["norms"], want["norms"])
        check(r["update_err"] <= SH_UPDATE_TOL, f"{label} rank {r['rank']}: the update of "
              f"{r['update_err_leaf']} is {r['update_err']:.3g} of the one-rank run's off "
              f"in norm (tol {SH_UPDATE_TOL})")
        f, tc, b, tc_b = r["counts"]
        check(min(tc, tc_b) >= layers * SH_STEPS and f == tc and b == tc_b,
              f"{label} rank {r['rank']}: flash launches {r['counts']}, want >= "
              f"{layers} tensor-core forward and backward a step")
        fwd += f
        bwd += b
        log(f"  {label} rank {r['rank']}: losses {r['losses']} (one rank {want['losses']}), "
            f"grad norms {[round(x, 4) for x in r['norms']]}, step times "
            f"{', '.join(f'{t * 1e3:.1f}' for t in r['times'])} ms, peak "
            f"{r['peak_gib']:.2f} GiB, flash {r['counts']}, updates of its "
            f"{r['update_leaves']} parameter shards off the one-rank run's by "
            f"{r['update_err_median']:.4g} in norm at the median, {r['update_err']:.4g} at "
            f"worst ({r['update_err_leaf']}; tol {SH_UPDATE_TOL})")
    return fwd, bwd


def phase_sharded(smi: str) -> tuple[int, int]:
    """Sharded training on torch.distributed (see the module docstring,
    item 17). Returns the flash forward and backward launches of its
    sharded runs (every rank's)."""
    import datetime

    import torch.distributed as dist

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    out_dir = ROOT / "build" / "phase17"
    out_dir.mkdir(parents=True, exist_ok=True)

    # (a) world size 1 over NCCL, against phase 10's make_step
    plain = plain_run(cfg, TRAIN_BATCH, SH_STEPS)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=SH_RANK_TIMEOUT_S))
    try:
        mesh = make_debug_mesh(1, 1)
        run = sharded_run(cfg, mesh, TRAIN_BATCH, SH_STEPS)
    finally:
        dist.destroy_process_group()
    fwd, tc, bwd, tc_bwd = run["counts"]
    check(min(tc, tc_bwd) >= cfg.num_layers * SH_STEPS and fwd == tc and bwd == tc_bwd,
          f"(a) flash launches {run['counts']}: want >= {cfg.num_layers} tensor-core "
          "forward and backward a step")
    losses_equal, loss_err = same_or_close("(a) losses", run["losses"], plain["losses"])
    params_equal, worst, where = True, 0.0, ""
    for (p, d), w in zip(leaves_with_paths(run["state"]["params"]), leaves(plain["params"])):
        local = d.to_local()
        if not torch.equal(local, w):
            params_equal = False
            err = leaf_err(local, w)
            if err > worst:
                worst, where = err, p
    check(worst <= SH_TOL, f"(a) parameters {worst:.3g} of max |x| off at {where}")
    sharded_specs = sum(any(e is not None for e in sp) for sp in run["p_specs"].values())
    log(f"  (a) {TRAIN_ARCH} at full width on a 1x1 mesh over NCCL ({sharded_specs} of "
        f"{len(run['p_specs'])} leaves with a sharded spec, every axis of size 1): "
        f"{SH_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}; losses {run['losses']} vs "
        f"make_step's {plain['losses']} ({'equal' if losses_equal else f'{loss_err:.3g} off'}); "
        f"updated parameters {'bit-equal' if params_equal else f'within {worst:.3g} of max |x| (worst {where})'}; "
        f"flash {run['counts']}; step times {', '.join(f'{t * 1e3:.1f}' for t in run['times'])} ms "
        f"(make_step {', '.join(f'{t * 1e3:.1f}' for t in plain['times'])} ms); peak "
        f"{run['peak_gib']:.2f} GiB; {smi}")
    want_qwen = out_dir / "qwen_params.pt"
    save_params(run["state"]["params"], want_qwen)
    want = dict(losses=run["losses"], norms=run["norms"])
    sh_fwd, sh_bwd = fwd, bwd
    del run, plain, mesh
    free_device("phase 17 (a)")

    # (b) several ranks on the one card over gloo, CUDA tensors
    t0 = time.perf_counter()
    reports = run_sharded_ranks("qwen", TRAIN_ARCH, None, SH_MESH, TRAIN_BATCH, want_qwen)
    f, b = check_rank_reports(f"(b) {TRAIN_ARCH} on {SH_MESH[0]}x{SH_MESH[1]}", reports,
                              cfg.num_layers, want)
    sh_fwd, sh_bwd = sh_fwd + f, sh_bwd + b
    log(f"  (b) {TRAIN_ARCH}: {len(reports)} ranks over gloo on one card, global batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} ({TRAIN_BATCH // SH_MESH[0]} x {TRAIN_SEQ} a rank), "
        f"wall {time.perf_counter() - t0:.1f} s (process start and build included); {smi}")

    ds_cfg = sharded_cfg(DS_ARCH, DS_TRAIN_LAYERS)
    plain = plain_run(ds_cfg, SH_DS_BATCH, SH_STEPS)
    want_ds = out_dir / "deepseek_params.pt"
    save_params(plain["params"], want_ds)
    log(f"  one rank: {DS_ARCH} at {DS_TRAIN_LAYERS} layers, {SH_STEPS} steps of "
        f"{SH_DS_BATCH} x {TRAIN_SEQ} through make_step: losses {plain['losses']}, step "
        f"times {', '.join(f'{t * 1e3:.1f}' for t in plain['times'])} ms")
    want = dict(losses=plain["losses"], norms=plain["norms"])
    del plain
    free_device(f"{DS_ARCH} one-rank run")
    t0 = time.perf_counter()
    reports = run_sharded_ranks("deepseek", DS_ARCH, DS_TRAIN_LAYERS, SH_DS_MESH,
                                SH_DS_BATCH, want_ds)
    f, b = check_rank_reports(f"(b) {DS_ARCH} on {SH_DS_MESH[0]}x{SH_DS_MESH[1]} (EP)",
                              reports, DS_TRAIN_LAYERS, want)
    sh_fwd, sh_bwd = sh_fwd + f, sh_bwd + b
    log(f"  (b) {DS_ARCH}: {len(reports)} ranks, experts over \"model\" (32 a rank), "
        f"batch {SH_DS_BATCH} x {TRAIN_SEQ} on each (data axis of size 1), wall "
        f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"  phase 17 flash launches: forward {sh_fwd}, backward {sh_bwd} (every rank); "
        f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return sh_fwd, sh_bwd


# ----------------------------------------------------------------- phase 18

def placed_params(params, mesh):
    """``params`` (the same on every rank) placed under the rules'
    shardings on ``mesh``."""
    p_sh = param_shardings(params, mesh)
    return unflatten(params, [place(w, sh) for w, sh in zip(leaves(params), leaves(p_sh))])


def greedy_against(spec, params, prompts: np.ndarray, want: np.ndarray, cache_len: int):
    """Greedy decode of ``prompts`` as ``serve_batch`` does; returns (tokens
    [b, SERVE_GEN], the first (step, row) where they leave ``want`` or
    None, and there this run's logit of its token less its logit of
    ``want``'s token)."""
    logits, caches = spec.prefill(params, prefill_input(spec, prompts), cache_len)
    toks, first = [], None
    for i in range(SERVE_GEN):
        tok = logits.argmax(-1)
        toks.append(tok.cpu().numpy())
        off = np.nonzero(toks[-1] != want[:, i])[0]
        if first is None and len(off):
            row = int(off[0])
            gap = float(logits[row, tok[row]] - logits[row, int(want[row, i])])
            first = (i, row, gap)
        if i < SERVE_GEN - 1:
            logits, caches = spec.decode_step(params, tok[:, None], caches,
                                              decode_pos(spec, i))
    return np.stack(toks, 1), first


def cache_placement(caches) -> list:
    """(split axes, slots held) of each layer's placed cache on this rank."""
    return [(list(c.split), c.cache.k.shape[2]) for c in caches["dense_stack"]]


def serve_rank(args: dict, mesh) -> dict:
    """One rank of phase 18 (a) on ``mesh``: qwen3-0.6b at 2 layers in f32,
    teacher-forced by the one-rank run's tokens, each step's logits held
    against that run's; then at full depth in bf16, phase 7's requests
    served greedily beside the one-rank run's tokens."""
    device = mesh_device(mesh)
    cfg = get_config(SERVE_ARCH)
    want = torch.load(args["want"], map_location="cpu", weights_only=False)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, num_layers=SV_F32_LAYERS)
    params = placed_params(build_model(cfg32).init(0, device), mesh)
    got = teacher_forced_logits(build_model(cfg32, mesh=mesh), params, want["prompts"],
                                want["forced"], cache_len=SV_CACHE_LEN)
    f32_errs = [float((g.cpu() - w).abs().max() / w.abs().max())
                for g, w in zip(got, want["logits"])]
    del params, got
    free_device("f32 check")

    spec = build_model(cfg, mesh=mesh)
    params = placed_params(build_model(cfg).init(0, device), mesh)
    queue = want["queue"][:SV_RANK_BATCHES * SERVE_BATCH]
    zero_flash_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = [greedy_against(spec, params, queue[i:i + SERVE_BATCH],
                              want["tokens"][i // SERVE_BATCH], SV_CACHE_LEN)
               for i in range(0, len(queue), SERVE_BATCH)]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = flash_counts()
    _, caches = spec.prefill(params, prefill_input(spec, queue[:SERVE_BATCH]), SV_CACHE_LEN)
    placement = cache_placement(caches)
    return dict(rank=args["rank"], f32_errs=f32_errs, serve_s=serve_s, counts=counts,
                tokens=[t.tolist() for t, _ in batches], first=[f for _, f in batches],
                placement=placement, batches=len(batches),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def serve_on_1x1(cfg, queue: list, smi: str) -> dict:
    """Phase 18 (a) in this process: phase 7's requests served by the
    sharded spec on a 1x1 mesh over NCCL and by the unsharded spec; tokens
    and teacher-forced logits must be bit-equal."""
    import datetime

    import torch.distributed as dist

    spec = build_model(cfg)
    params = spec.init(0, "cuda")
    plain, plain_s = serve_requests(spec, params, queue)
    prompts = np.stack(queue[:SERVE_BATCH])
    forced = plain[0][:, :SERVE_GEN - 1]
    want = teacher_forced_logits(spec, params, prompts, forced)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=SH_RANK_TIMEOUT_S))
    try:
        mesh = make_debug_mesh(1, 1)
        sspec, placed = build_model(cfg, mesh=mesh), placed_params(params, mesh)
        zero_flash_counts()
        got_batches, got_s = serve_requests(sspec, placed, queue)
        counts = flash_counts()
        got = teacher_forced_logits(sspec, placed, prompts, forced)
    finally:
        dist.destroy_process_group()
    for a_, b_ in zip(got_batches, plain):
        check(np.array_equal(a_, b_), "(a) 1x1: served tokens differ from serve_batch's")
    for i, (a_, b_) in enumerate(zip(got, want)):
        check(torch.equal(a_, b_), f"(a) 1x1: logits of step {i} differ "
              f"(max |d| {float((a_ - b_).abs().max()):.3g})")
    fwd, tc = counts[:2]
    check(fwd == tc and fwd >= cfg.num_layers * len(plain),
          f"(a) 1x1: flash launches {counts}, want >= {cfg.num_layers} a prefill, "
          "all tensor-core")
    log(f"  (a) {SERVE_ARCH} on a 1x1 mesh over NCCL: {len(queue)} requests in "
        f"{len(plain)} batches, tokens and {len(got)} teacher-forced logits bit-equal to "
        f"the unsharded spec's; flash {fwd} ({tc} tensor-core); served in {got_s:.3f} s "
        f"(unsharded {plain_s:.3f} s); {smi}")
    return dict(tokens=plain, launches=fwd)


def f32_reference(cfg, prompts: np.ndarray) -> dict:
    """Phase 18 (a)'s one-rank f32 run at 2 layers: prefill and
    SV_F32_STEPS greedy decode steps at SV_CACHE_LEN; its prompts, tokens
    and logits (on the host)."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, num_layers=SV_F32_LAYERS)
    spec = build_model(cfg32)
    params = spec.init(0, "cuda")
    logits, caches = spec.prefill(params, prefill_input(spec, prompts), SV_CACHE_LEN)
    out, forced = [logits.cpu()], []
    for i in range(SV_F32_STEPS):
        tok = logits.argmax(-1)[:, None]
        forced.append(tok.cpu().numpy())
        logits, caches = spec.decode_step(params, tok, caches, decode_pos(spec, i))
        out.append(logits.cpu())
    return dict(prompts=prompts, forced=np.concatenate(forced, 1), logits=out)


def start_dryruns(out_dir: Path) -> list:
    """Phase 18 (b) and (c)'s dry-run cells as ``python -m
    repro_torch.launch.dryrun`` subprocesses with no card visible, all
    started at once: DRY_CELLS, and phase 10's step (4 x 2048) on a 1x1
    mesh."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    cells = [["--arch", a, "--shape", sh, *(["--multi-pod"] if multi else [])]
             for a, sh, multi in DRY_CELLS]
    cells.append(["--arch", TRAIN_ARCH, "--shape", "train_4k", "--mesh", "1x1",
                  "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)])
    return [(cell, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *cell, "--results", str(out_dir)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cell in cells]


def finish_dryruns(procs: list) -> None:
    """Wait for :func:`start_dryruns`' subprocesses (each within
    DRY_TIMEOUT_S of its start); any that fails fails the phase."""
    failures = []
    try:
        for cell, t0, proc in procs:
            try:
                output, _ = proc.communicate(timeout=max(1.0, DRY_TIMEOUT_S - (
                    time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                failures.append(f"{cell} outlived {DRY_TIMEOUT_S} s")
                continue
            if proc.returncode:
                failures.append(f"{cell} exit {proc.returncode}:\n{output[-3000:]}")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(not failures, "dry-run: " + "\n".join(failures))


def roofline_against_card(row: dict, smi: str) -> dict:
    """Phase 18 (c): phase 10's step on the card (make_step, 4 x 2048,
    bf16, remat) against the dry-run's count of the same step."""
    cfg = get_config(TRAIN_ARCH)
    spec = build_model(cfg)
    opt_cfg = sharded_opt_cfg()
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = make_state(spec, opt_cfg, 0, compression=False, device="cuda")
    step = make_step(spec, opt_cfg, compression=False)
    times, peaks = [], []
    for i in range(ROOF_STEPS):
        batch = data.batch_at(i, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        check(bool(torch.isfinite(m["loss"])), "(c) non-finite loss")
    del state
    ms = statistics.median(times[1:])
    peak = max(peaks[1:])
    bound_ms = max(row["t_compute"], row["t_memory"], row["t_collective"]) * 1e3
    ratio = row["peak_bytes_per_dev"] / peak
    log(f"  (c) {TRAIN_ARCH} step of {TRAIN_BATCH} x {TRAIN_SEQ} (bf16, remat) on the card: "
        f"{', '.join(f'{t:.1f}' for t in times)} ms, median of steps 2..{ROOF_STEPS} "
        f"{ms:.2f} ms; peak {peak / 2**30:.3f} GiB over the state's start; {smi}")
    log(f"  (c) dry-run of the same step on a 1x1 fake mesh: {row['hlo_flops_per_dev']:.4g} "
        f"FLOPs, {row['hlo_bytes_per_dev']:.4g} bytes (every op's, unfused), t_compute "
        f"{row['t_compute'] * 1e3:.2f} ms, t_memory {row['t_memory'] * 1e3:.2f} ms -> bound "
        f"{bound_ms:.2f} ms ({row['bottleneck']}); predicted peak "
        f"{row['peak_bytes_per_dev'] / 2**30:.3f} GiB = {ratio:.3f} x the card's")
    check(ms >= bound_ms, f"(c) the measured step {ms:.2f} ms beats the roofline bound "
          f"{bound_ms:.2f} ms: the count is wrong")
    check(PEAK_BAND[0] <= ratio <= PEAK_BAND[1],
          f"(c) predicted peak {ratio:.3f} x the measured, outside {PEAK_BAND}")
    mfu = row["model_flops"] / (989e12 * ms / 1e3)
    log(f"  (c) whole-step share: bound / measured = {bound_ms / ms:.4f}; mfu_upper_bound "
        f"{row['mfu_upper_bound']:.4f}; measured MFU (6 N D over the bf16 peak) {mfu:.4f}")
    return dict(ms=ms, bound_ms=bound_ms, peak=peak, ratio=ratio)


def phase_sharded_serve(smi: str) -> int:
    """Sharded serving, the dry-run and the roofline (see the module
    docstring, item 18). Returns the flash forward launches of its sharded
    serving runs (every rank's)."""
    from repro_torch.roofline.report import roofline_table

    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "phase18"
    shutil.rmtree(out_dir, ignore_errors=True)
    dry_dir = out_dir / "dryrun"
    dry = start_dryruns(dry_dir)

    cfg = get_config(SERVE_ARCH)
    rng = np.random.default_rng(0)
    queue = [rng.integers(1, cfg.vocab, size=SERVE_PROMPT) for _ in range(SERVE_REQUESTS)]
    one = serve_on_1x1(cfg, queue, smi)
    launches = one["launches"]
    want = f32_reference(cfg, np.stack(queue[:SERVE_BATCH]))
    want.update(queue=np.stack(queue), tokens=one["tokens"])
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(want, out_dir / "want.pt")
    del want
    free_device("phase 18 (a) one rank")

    t0 = time.perf_counter()
    reports = run_sharded_ranks("serve", SERVE_ARCH, None, SV_MESH, SERVE_BATCH,
                                out_dir / "want.pt", out_dir=out_dir, job="serve")
    layers = cfg.num_layers
    for r in reports:
        err = max(r["f32_errs"])
        check(err <= SV_F32_TOL, f"(a) 2x2 rank {r['rank']}: f32 logits {err:.3g} of max "
              f"|logit| off the one-rank run's (tol {SV_F32_TOL})")
        fwd, tc = r["counts"][:2]
        check(fwd == tc and fwd >= layers * r["batches"],
              f"(a) 2x2 rank {r['rank']}: flash launches {r['counts']}, want >= {layers} a "
              "prefill, all tensor-core")
        # L 28 over data 2: this rank's 14 layers hold 16384 / 2 slots, the rest none
        held = [h for _, h in r["placement"]]
        d = r["rank"] // SV_MESH[1]
        want_held = [SV_CACHE_LEN // SV_MESH[1] if i // (layers // SV_MESH[0]) == d else 0
                     for i in range(layers)]
        check(held == want_held and all(sp == ["data", "model"] for sp, _ in r["placement"]),
              f"(a) 2x2 rank {r['rank']}: cache placement {r['placement'][:2]}...")
        same = float(np.mean([np.array_equal(np.array(t), o)
                              for t, o in zip(r["tokens"], one["tokens"])]))
        launches += fwd
        log(f"  (a) 2x2 rank {r['rank']}: f32 at {SV_F32_LAYERS} layers, prefill + "
            f"{SV_F32_STEPS} steps within {err:.3g} of max |logit| (tol {SV_F32_TOL}); bf16 "
            f"full depth: {r['batches']} x {SERVE_BATCH} requests served in "
            f"{r['serve_s']:.2f} s, batches with every token equal to one rank's: "
            f"{same:.0%}, first divergence (step, "
            f"row, logit gap) {r['first']}; flash {r['counts'][:2]}; cache layers held "
            f"{sum(1 for h in held if h)} of {layers}, {max(held)} slots each; peak "
            f"{r['peak_gib']:.2f} GiB")
    log(f"  (a) {SERVE_ARCH} on {SV_MESH[0]}x{SV_MESH[1]} over gloo (4 ranks on one card), "
        f"cache {SV_CACHE_LEN} slots: wall {time.perf_counter() - t0:.1f} s (process start "
        "included)")
    free_device("phase 18 (a)")

    finish_dryruns(dry)
    rows = [json.loads(f.read_text()) for f in sorted(dry_dir.glob("*.json"))]
    for r in rows:
        log(f"  (b) dry-run {r['arch']} {r['shape']} on {r['mesh']}: build {r['build_s']} s, "
            f"counted run {r['run_s']} s (the cells at once on the host, no card visible, "
            f"beside (a)'s ranks)")
        if r["mesh"] == "1x1":
            continue
        check(r["ok"] and r["hlo_flops_per_dev"] > 0 and 0 < r["useful_flops_ratio"] <= 1,
              f"(b) dry-run {r['arch']} {r['shape']} {r['mesh']}: {r}")
    for mesh in ("16x16", "2x16x16"):
        log(f"  (b) dry-run rows, {mesh}:\n{roofline_table(rows, mesh)}")
    check(len(rows) == len(DRY_CELLS) + 1, f"(b) {len(rows)} dry-run results")
    row = next(r for r in rows if r["mesh"] == "1x1")
    roof = roofline_against_card(row, smi)
    free_device("phase 18 (c)")
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"  phase 18 flash launches (every rank): {launches}; roofline share "
        f"{roof['bound_ms'] / roof['ms']:.4f}; phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------------- phase 19

@contextlib.contextmanager
def expandable_segments():
    """The caching allocator's expandable segments for the block, its
    cache emptied before and after (PYTORCH_CUDA_ALLOC_CONF's setting, set
    at run time so that the other phases keep the default)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def phase_gemma2() -> tuple[int, int, float, float]:
    """gemma2-9b (see the module docstring, item 19). Returns the flash
    forward and backward launches of the phase's serving and training
    runs, and the largest |kernel - plain| of the forward (on the prefill
    and training activations) and of the backward (on the training
    activations)."""
    t_phase = time.perf_counter()
    cfg = get_config(G2_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
           cfg.d_ff, cfg.vocab, cfg.sliding_window, cfg.window_pattern, cfg.attn_softcap,
           cfg.final_softcap, cfg.sandwich_norm, cfg.mlp_kind, cfg.tie_embeddings,
           cfg.embed_scale, cfg.attn_scale, cfg.dtype, cfg.remat)
          == (42, 3584, 16, 8, 256, 14336, 256000, G2_WINDOW, "alternating", 50.0, 30.0,
              True, "geglu", True, True, 256.0 ** -0.5, torch.bfloat16, True),
          f"{G2_ARCH} is not at full width and depth")
    windows = lm.layer_windows(cfg, cfg.num_layers)
    local = [i for i, w in enumerate(windows) if w]
    check(local == list(range(0, cfg.num_layers, 2))
          and set(windows.tolist()) == {0, G2_WINDOW}, f"{G2_ARCH} windows {windows}")
    t0 = time.perf_counter()
    run = family_serve(cfg, seed=25, prompt=G2_PROMPT)
    check(run["n_params"] == G2_PARAMS, f"{G2_ARCH}: {run['n_params']} params")
    check(run["launches"] == cfg.num_layers * run["batches"] and run["tc"] == run["launches"]
          and run["one"] == run["one_tc"] == cfg.num_layers,
          f"{G2_ARCH} serving: flash launches {run['launches']} ({run['tc']} tensor-core), "
          f"one prefill {run['one']} ({run['one_tc']}); want {cfg.num_layers} a prefill, "
          "all tensor-core")
    # the first local layer, the first global one and the last (global)
    layers = tuple(sorted({0, 1, cfg.num_layers - 1}))
    want_kw = {i: {"window": G2_WINDOW if windows[i] else None, "softcap": cfg.attn_softcap}
               for i in layers}
    fwd_err = check_prefill_activations(run["spec"], run["params"], run["prompts"], layers,
                                        want_kw)
    serve_launches = run["launches"]
    del run
    free_device(f"{G2_ARCH} serving ({time.perf_counter() - t0:.1f} s with the init)")
    # the plain versions are not timed here: at these shapes they take
    # 0.6-2.4 s a call and time nothing the card's users run
    for window in (None, G2_WINDOW):
        phase_flash_timing(G2_SHAPE, f"{G2_ARCH} prefill shape", f32=False, window=window,
                           plain=False)
    f32_parity(dataclasses.replace(cfg, num_layers=G2_F32_LAYERS), 26, G2_PROMPT,
               G2_F32_STEPS)
    free_device(f"{G2_ARCH} f32 check")

    train_cfg = dataclasses.replace(cfg, num_layers=G2_TRAIN_LAYERS)
    predicted = predicted_peak_gib(train_cfg, G2_TRAIN_BATCH, G2_TRAIN_SEQ)
    log(f"  {G2_ARCH} training cut: {G2_TRAIN_LAYERS} layers (windows "
        f"{lm.layer_windows(train_cfg, G2_TRAIN_LAYERS).tolist()}), {G2_TRAIN_BATCH} x "
        f"{G2_TRAIN_SEQ}; predicted peak {predicted:.2f} GiB (the dry-run's count on meta)")
    # The step's f32 logits over vocab 256000 come and go in 7.8 GiB blocks
    # whose sizes vary; in fixed segments they left 26.9 GiB reserved but
    # unallocated, and the step ran out of memory at 47.7 GiB allocated.
    # Segments that grow in place keep the reserve at what is in use.
    with expandable_segments():
        fwd, tc, bwd, tc_bwd = family_train(train_cfg, G2_TRAIN_STEPS, batch=G2_TRAIN_BATCH,
                                            seq=G2_TRAIN_SEQ, profile=True)
    # remat: each layer's forward runs twice a step (the pass and the recompute)
    want = (2 * G2_TRAIN_LAYERS * G2_TRAIN_STEPS, G2_TRAIN_LAYERS * G2_TRAIN_STEPS)
    check((fwd, bwd) == want and tc == fwd and tc_bwd == bwd,
          f"{G2_ARCH} training: flash forward {fwd} ({tc} tensor-core), backward {bwd} "
          f"({tc_bwd} tensor-core); want {want[0]} and {want[1]}, all tensor-core")
    free_device(f"{G2_ARCH} training")
    # the D 256 backward on what its first local and first global layer see
    bwd_err = 0.0
    with expandable_segments():
        seen = training_activations(G2_ARCH, G2_TRAIN_BATCH, G2_TRAIN_SEQ, layers=(0, 1),
                                    num_layers=G2_TRAIN_LAYERS)
    for label, q, k, v, do, kw in seen:
        fwd_err = max(fwd_err, check_fwd_activations(f"{G2_ARCH} {label}", q, k, v, kw))
        bwd_err = max(bwd_err, check_bwd_case(f"{G2_ARCH} {label}", q, k, v, do, kw))
    free_device(f"{G2_ARCH} training activations")
    phase_flash_bwd_timing(G2_BWD_SHAPE, f"{G2_ARCH} training shape", f32=False, plain=False)
    phase_flash_bwd_timing(G2_BWD_SHAPE, f"{G2_ARCH} training shape, local layer", f32=False,
                           window=G2_WINDOW, softcap=cfg.attn_softcap, plain=False)
    log(f"  phase 19 flash launches: forward {serve_launches + fwd} (serving "
        f"{serve_launches}, training {fwd}), backward {bwd}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return serve_launches + fwd, bwd, fwd_err, bwd_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA GPU",
              file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[1] device: {kind} x{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:      # one nvcc per source
        libs = list(pool.map(lambda name: _build.build(name, verbose=True), KERNELS))
    log(f"[2] build: {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s")

    log("[3] small programs: kernel vs plain version, oracle and interpreter")
    phase_small()

    log(f"[4] main path: {', '.join(FULL_KERNELS)} on {FULL_GRID[0]}x{FULL_GRID[1]}, "
        f"B={FULL_BATCH}, num_iters={FULL_ITERS}")
    suite = load_suite(list(FULL_KERNELS))
    torch.cuda.reset_peak_memory_stats()
    cgra_sim.launches = 0
    flash_attention.launches = 0
    flash_attention.tensor_core_launches = 0
    runs = drive_main_path(suite)
    launches = cgra_sim.launches
    log(f"  cgra_sim launches on the main path: {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches >= 1, "the main path never launched cgra_sim")
    max_err = 0.0
    for name in reversed(FULL_KERNELS):   # largest trace first, then freed
        max_err = max(max_err, check_full(name, runs[name]))
        runs[name].pop("trace")
        runs[name].pop("outs")
        torch.cuda.empty_cache()

    log(f"[5] timing on {smi}")
    rows = phase_timing(runs)
    main_row = rows[FULL_KERNELS[0]]
    del runs, rows
    torch.cuda.empty_cache()

    log("[6] flash_attention kernel vs its plain version")
    flash_err = phase_flash()

    log(f"[7] serving path: {SERVE_ARCH} at full width, {SERVE_REQUESTS} requests, "
        f"batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_GEN} generated tokens")
    flash_launches = phase_serve()

    log(f"[8] flash_attention timing on {smi}")
    flash_row = phase_flash_timing()

    log("[9] flash_attention backward kernels vs their plain version and autograd")
    bwd_err = phase_flash_bwd()

    log(f"[10] training path: {TRAIN_ARCH} at full width, {TRAIN_STEPS} steps of "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, then {COMPRESSION_STEPS} with compression")
    bwd_launches = phase_train()

    log(f"[11] flash_attention backward timing on {smi}")
    bwd_row = phase_flash_bwd_timing()

    log(f"[12] compiler API path: the suite premapped on {API_GRID}x{API_GRID}, "
        f"warm session, {LARGE_PRESET} (anneal), {HETERO_PRESET}; "
        f"B={FULL_BATCH}, num_iters={FULL_ITERS}")
    api_launches, _ = phase_api(smi)

    log(f"[13] compile daemon, tracing frontend, fuzz generator and stage placement: "
        f"the suite through python -m repro_torch.daemon on {API_GRID}x{API_GRID}, "
        f"three traced loops, random_dfg seeds 0-{FUZZ_SEEDS - 1} on "
        f"{len(FUZZ_FABRICS)} fabrics, examples/pipeline_placement_torch.py")
    daemon_launches = phase_daemon()

    log(f"[14] the DeepSeek family: {DS_ARCH} served at full width and depth "
        f"({SERVE_REQUESTS} requests, batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
        f"{SERVE_GEN} tokens), the flash kernel at its prefill shape, f32 at "
        f"{DS_F32_LAYERS} layers, training at {DS_TRAIN_LAYERS} layers; {V3_ARCH} at "
        f"{V3_LAYERS} layers")
    ds_fwd, ds_bwd, ds_err = phase_deepseek()

    log(f"[15] the SSM and hybrid families: {HY_ARCH} at full width and depth served "
        f"({SERVE_REQUESTS} requests, batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
        f"{SERVE_GEN} tokens), the flash kernel at its prefill shapes, f32 checks, "
        f"{HY_TRAIN_STEPS} training steps; {XL_ARCH} served (prompt {XL_PROMPT}), checked in "
        f"f32, {XL_TRAIN_STEPS} training steps at {XL_TRAIN_LAYERS} layers")
    hy_fwd, hy_bwd, hy_err = phase_ssm_hybrid()

    log(f"[16] the vision-language and audio families: {PG_ARCH} and {WH_ARCH} at full "
        f"width and depth served ({SERVE_REQUESTS} requests, batch {SERVE_BATCH}, prompts "
        f"{SERVE_PROMPT} and {WH_PROMPT}, {SERVE_GEN} tokens), the flash kernel at their "
        f"prefill shapes, f32 checks, {PG_TRAIN_STEPS} and {WH_TRAIN_STEPS} training steps")
    va_fwd, va_bwd, va_err, va_bwd_err = phase_vlm_audio()

    log(f"[17] sharded training on torch.distributed: {TRAIN_ARCH} at full width, "
        f"{SH_STEPS} steps of make_sharded_step on a 1x1 mesh over NCCL (against "
        f"make_step), on {SH_MESH[0]}x{SH_MESH[1]} over gloo (4 ranks on the one card); "
        f"{DS_ARCH} at {DS_TRAIN_LAYERS} layers on {SH_DS_MESH[0]}x{SH_DS_MESH[1]} (EP)")
    sh_fwd, sh_bwd = phase_sharded(smi)

    log(f"[18] sharded serving, the dry-run and the roofline: {SERVE_ARCH} served on a "
        f"1x1 mesh over NCCL and on {SV_MESH[0]}x{SV_MESH[1]} over gloo ({SV_CACHE_LEN}-slot "
        f"caches); python -m repro_torch.launch.dryrun on {len(DRY_CELLS)} production "
        f"cells; phase 10's step against its roofline")
    sv_fwd = phase_sharded_serve(smi)

    log(f"[19] {G2_ARCH} at full width and depth served ({SERVE_REQUESTS} requests, batch "
        f"{SERVE_BATCH}, prompt {G2_PROMPT}, {SERVE_GEN} tokens), the flash kernel at its "
        f"prefill shape, f32 at {G2_F32_LAYERS} layers, {G2_TRAIN_STEPS} training steps of a "
        f"{G2_TRAIN_LAYERS}-layer cut at {G2_TRAIN_BATCH} x {G2_TRAIN_SEQ}, the D 256 "
        f"backward on its activations and timed")
    g2_fwd, g2_bwd, g2_err, g2_bwd_err = phase_gemma2()
    log(f"whole script: {time.perf_counter() - T_START:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "cgra_sim",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cgra_sim.cu",
        "replaces": "src/repro/kernels/cgra_sim.py:75",
        "launches": launches + api_launches + daemon_launches,
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": flash_launches + ds_fwd + hy_fwd + va_fwd + sh_fwd + sv_fwd + g2_fwd,
        "max_abs_err": max(flash_err, ds_err, hy_err, va_err, g2_err),
        "ms": flash_row["ms"],
        "plain_ms": flash_row["plain_ms"],
        "bound_ms": flash_row["bound_ms"],
        "bound_by": flash_row["bound_by"],
        "library_ms": flash_row["library_ms"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": bwd_launches + ds_bwd + hy_bwd + va_bwd + sh_bwd + g2_bwd,
        "max_abs_err": max(bwd_err, va_bwd_err, g2_bwd_err),
        "ms": bwd_row["ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--sharded-rank":
        sharded_rank(json.loads(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())
