"""End-to-end training driver.

The PyTorch counterpart of the JAX package's ``src/repro/launch/train.py``.
Trains every family: dense (qwen3-0.6b, gemma2-9b/27b, mistral-nemo-12b),
MoE (deepseek-moe-16b, deepseek-v3-671b), vlm (paligemma-3b: the batch's
``prefix_embeds`` under prefix-LM masking), audio (whisper-small: the
batch's ``frames`` through the encoder), SSM (xlstm-125m) and hybrid
(hymba-1.5b), full size,
``--params100m`` or ``--reduced``, on one device (CUDA unless ``--device
cpu``), with the substrate ported so far: synthetic data, AdamW (+ optional
int8 gradient compression with error feedback), async checkpointing and the
fault-tolerant runner (restart from checkpoint, straggler accounting).
Causal attention's forward and gradient run in the hand-written
flash-attention kernels on the card; prefix-LM, bidirectional and
cross-attention and the recurrent mixers are plain torch ops.

  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
      --reduced --device cpu --steps 20 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch paligemma-3b \\
      --steps 2 --batch 2 --seq 2048

Weights are random, from a ``torch.Generator`` seeded by ``--seed``.

On a mesh (``launch/mesh.py``), :func:`make_sharded_state` places the state
under the rules' shardings and :func:`make_sharded_step` is the counterpart
of the reference's ``jax.jit(train_step, in_shardings=(p_sh, o_sh, b_sh),
out_shardings=(p_sh, o_sh, None))``: every rank of the default process
group calls it on its shards. The CLI trains on one device, as the
reference's does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..configs import get_config
from ..data import SyntheticLM
from ..kernels.ops import resolve_device
from ..models import build_model, param_count
from ..optim import (
    AdamWConfig, adamw_init, adamw_update, compress_grads_with_feedback,
    init_residual,
)
from ..runtime import FaultConfig, run_training
from ..tree import leaves, tree_map, unflatten


def make_state(spec, opt_cfg, seed: int, *, compression: bool, device="cuda") -> dict:
    params = spec.init(seed, device)
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    if compression:
        state["residual"] = init_residual(params)
    return state


def make_step(spec, opt_cfg, *, compression: bool):
    """``step(state, batch) -> (new_state, metrics)``: the loss and its
    gradient over every parameter leaf (``torch.autograd.grad``), optional
    compression with error feedback, then the AdamW update. Metrics:
    loss, ce, aux, grad_norm and lr, as 0-d tensors. The state passed in is
    left as it is."""
    def step(state, batch):
        params = state["params"]
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            loss, metrics = spec.loss_fn(unflatten(params, flat), batch)
            grads = unflatten(params, torch.autograd.grad(loss, flat))
        del flat
        if compression:
            grads, new_residual = compress_grads_with_feedback(grads, state["residual"])
        new_params, new_opt, om = adamw_update(grads, state["opt"], params, opt_cfg)
        new_state = {"params": new_params, "opt": new_opt}
        if compression:
            new_state["residual"] = new_residual
        out = {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}, **om}
        return new_state, out

    return step


def make_sharded_state(opt_cfg, params, p_sh, o_sh, *, compression: bool) -> dict:
    """The state of :func:`make_state` placed on the mesh: ``params`` (the
    whole tree, the same on every rank: the same seed, or a tree carried in)
    under ``p_sh``, zero moments under ``o_sh`` (ZeRO-1), step 0 replicated
    and the compression residual placed like the params."""
    from ..sharding.spmd import place

    placed = unflatten(params, [place(w, sh) for w, sh in zip(leaves(params), leaves(p_sh))])
    opt = adamw_init(params, opt_cfg)
    state = {"params": placed, "opt": {
        "m": unflatten(params, [place(z, sh) for z, sh in zip(leaves(opt["m"]),
                                                               leaves(o_sh["m"]))]),
        "v": unflatten(params, [place(z, sh) for z, sh in zip(leaves(opt["v"]),
                                                               leaves(o_sh["v"]))]),
        "step": place(opt["step"], o_sh["step"]),
    }}
    if compression:
        state["residual"] = unflatten(params, [
            place(r, sh) for r, sh in zip(leaves(init_residual(params)), leaves(p_sh))])
    return state


def sharded_grads(spec, params, batch: dict, spmd):
    """This rank's (loss, metrics, gradients): the loss of its batch shard
    under ``spec`` (built on the mesh), and each parameter's gradient shard,
    in leaf order, of the global loss (the mean of the ranks' losses over
    the data axes), summed over the axes the leaf is replicated on."""
    from torch.distributed.tensor import DTensor

    from ..sharding.spmd import spec_of, sum_replicated

    flat = leaves(params)
    locs = [d.to_local().detach().requires_grad_() for d in flat]
    placed = unflatten(params, [
        DTensor.from_local(t, d.device_mesh, d.placements, run_check=False,
                           shape=d.shape, stride=d.stride())
        for t, d in zip(locs, flat)])
    local_batch = {k: v.to_local() if isinstance(v, DTensor) else v
                   for k, v in batch.items()}
    with torch.enable_grad():
        loss, metrics = spec.loss_fn(placed, local_batch)
        grads = torch.autograd.grad(loss / spmd.world, locs)
    specs = [spec_of(d) for d in flat]
    return loss.detach(), metrics, sum_replicated(list(grads), specs, spmd)


def make_sharded_step(spec, opt_cfg, mesh, p_sh, o_sh, b_sh, *, compression: bool = False,
                      data_axes=("data",), model_axis: str = "model"):
    """``step(state, batch) -> (new_state, metrics)`` on placed state.

    ``spec`` comes from ``build_model(cfg, mesh=mesh, ...)``; ``state`` is
    :func:`make_sharded_state`'s (DTensors under ``p_sh`` and ``o_sh``),
    ``batch`` a dict of DTensors under ``b_sh`` (``batch_at(step,
    shardings=b_sh)``). Each rank takes the gradient of its local loss
    (seeded with ``1 / world``), sums each leaf's gradient over the axes it
    is replicated on, optionally compresses it with error feedback (on the
    whole tensor, as the reference's step compresses its global gradient),
    and runs AdamW on its shards. Metrics, the same on every rank: loss, ce,
    aux (and mtp) averaged over the data axes, grad_norm and lr. On a 1x1
    mesh the step computes what :func:`make_step` computes, op for op."""
    from ..sharding.spmd import Spmd, all_reduce

    spmd = Spmd(mesh, data_axes=data_axes, model_axis=model_axis)

    def step(state, batch):
        loss, metrics, grads = sharded_grads(spec, state["params"], batch, spmd)
        new_state, om = sharded_update(state, grads, opt_cfg, spmd, compression=compression)
        dsize = spmd.size(spmd.data_axes)
        out = {k: all_reduce(v.detach(), spmd, spmd.data_axes) / dsize
               for k, v in {"loss": loss, **metrics}.items()}
        return new_state, {**out, **om}

    return step


@torch.no_grad()
def sharded_update(state: dict, grads: list, opt_cfg, spmd, *, compression: bool):
    """The placed state after one update from this rank's gradient shards
    (``sharded_grads``' list, in the params' layout): optional compression
    with error feedback, each gradient made whole first (the reference
    quantises its global gradient in 256-blocks), then AdamW with ZeRO-1
    moments. Returns (new_state, {grad_norm, lr})."""
    from torch.distributed.tensor import DTensor

    from ..optim import adamw_update_sharded
    from ..sharding.spmd import full_tensor, reshard, spec_of

    new_state = {}
    if compression:
        specs = [spec_of(d) for d in leaves(state["params"])]
        whole = [reshard(g, sp, (), spmd) for g, sp in zip(grads, specs)]
        deq, res = compress_grads_with_feedback(
            unflatten(state["params"], whole),
            tree_map(lambda r: full_tensor(r, spmd), state["residual"]))
        grads = [reshard(g, (), sp, spmd) for g, sp in zip(leaves(deq), specs)]
        new_state["residual"] = unflatten(state["residual"], [
            DTensor.from_local(reshard(x, (), sp, spmd).contiguous(), r.device_mesh,
                               r.placements, run_check=False, shape=r.shape,
                               stride=r.stride())
            for x, sp, r in zip(leaves(res), specs, leaves(state["residual"]))])
    new_params, new_opt, om = adamw_update_sharded(
        unflatten(state["params"], grads), state["opt"], state["params"], opt_cfg, spmd)
    return {"params": new_params, "opt": new_opt, **new_state}, om


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--params100m", action="store_true",
                    help="~120M-param family member (the end-to-end driver scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.params100m:
        # ~120M-parameter member of the chosen family (end-to-end driver scale)
        cfg = dataclasses.replace(
            cfg, num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab=50_304, scan_layers=False,
            dtype=torch.float32,
        )
    elif args.reduced:
        cfg = cfg.reduced()
    spec = build_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))

    state = make_state(spec, opt_cfg, args.seed, compression=args.grad_compression,
                       device=device)
    print(f"{args.arch}: {param_count(state['params'])/1e6:.2f}M params, "
          f"device {device}")

    data = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)
    step_fn = make_step(spec, opt_cfg, compression=args.grad_compression)

    t0 = time.perf_counter()
    fault_cfg = FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    state, report = run_training(
        step_fn, state, lambda s: data.batch_at(s, device), args.steps, fault_cfg,
    )
    dt = time.perf_counter() - t0
    print(
        f"done: {report.steps_done} steps in {dt:.1f}s "
        f"({dt/max(1,report.steps_done)*1e3:.1f} ms/step), "
        f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f}, "
        f"restarts={report.restarts}, stragglers={report.straggler_events}"
    )
    return report


if __name__ == "__main__":
    main()
