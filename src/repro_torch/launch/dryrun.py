"""Multi-pod dry-run: count every (arch x shape x mesh) cell's step, no card.

The PyTorch counterpart of the JAX package's ``src/repro/launch/dryrun.py``,
with its CLI and result keys (``roofline/report.py`` renders both
packages' files). Per cell, in one process:

  * a fake process group (``torch.testing``'s ``FakeStore``) of world 256
    (16x16) or 512 (2x16x16) as rank 0, and ``make_production_mesh`` on
    it: collectives return at once and move nothing;
  * the model, its parameters, optimizer state, batch and caches on
    ``meta`` (shapes and dtypes only; nothing is allocated), placed under
    the rules' shardings as on a real mesh;
  * the port's own sharded step on rank 0's shards: training is
    ``launch/train.py::make_sharded_step``, prefill and decode the
    ``prefill`` and ``decode_step`` of ``build_model(cfg, mesh=...)``,
    run once under ``roofline.analysis.measure_step`` (FLOPs, bytes of
    every op, collectives, peak live bytes), then persisted with its
    roofline terms.

``cost_method`` is ``"direct (every layer run)"``: the port runs every
layer eagerly, so the counts are exact for the whole depth, and the
reference's ``_depth_variants`` extrapolation (a scanned layer body counts
once in XLA's cost analysis) has no counterpart. The peak is the port's
eager peak: a prefill cell holds the caches it writes (the reference's
prefill cell returns only logits, so XLA drops the cache writes), and
prefill and decode return the whole logits on every rank, an all-gather
the reference's sharded logits do without.

Run one cell:   PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --multi-pod
Run everything: PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--results DIR]
(--all orchestrates one subprocess per cell, which keeps the fake process
group to one cell and makes the sweep resumable; finished cells are
skipped.) ``--mesh 2x2x2`` (or any ``[pod x] data x model``) replaces the
production mesh, ``--batch`` and ``--seq`` the shape's global batch and
sequence length, ``--reduced`` the config with its ``reduced()``.

Knobs (``--set key=val``): ``moe_capacity``, ``remat``, ``fsdp``,
``replicate_patterns``, ``ep_all``, ``batch_over_model`` and
``compress_grads``, as in the reference. ``act_constraints`` and
``no_extrapolate`` raise: the port has no XLA sharding hints (its
activations are laid out by construction, ``models/sharded.py``) and no
scan to extrapolate.

The dry-run needs no card: it counts a step, it does not run one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

_TRUE = (True, "1", "true")
_UNSUPPORTED = {
    "act_constraints": "the port has no XLA sharding hints: its activations are "
                       "laid out by construction (models/sharded.py)",
    "no_extrapolate": "the port runs every layer eagerly; there is no scan to "
                      "extrapolate",
}


def mesh_name(shape: tuple[int, ...]) -> str:
    return "x".join(map(str, shape))


def run_cell(arch: str, shape_name: str, multi_pod: bool, results_dir: str,
             opt_flags: dict | None = None, *, mesh_shape: tuple[int, ...] | None = None,
             batch: int | None = None, seq: int | None = None,
             reduced: bool = False) -> dict:
    """Count one cell on rank 0 of a fake process group (initialised here
    and destroyed before returning), persist and return its result."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    opt_flags = opt_flags or {}
    for key, why in _UNSUPPORTED.items():
        if opt_flags.get(key) is not None:
            raise ValueError(f"--set {key}: {why}")
    shape_mesh = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    dist.init_process_group("fake", rank=0, world_size=math.prod(shape_mesh),
                            store=FakeStore())
    try:
        result = _count_cell(arch, shape_name, shape_mesh, opt_flags, batch=batch,
                             seq=seq, reduced=reduced)
    finally:
        dist.destroy_process_group()
    _persist(results_dir, result)
    print(json.dumps(result, indent=2))
    return result


def _count_cell(arch, shape_name, shape_mesh, opt_flags, *, batch, seq, reduced) -> dict:
    import torch

    from ..configs import get_config
    from ..launch.mesh import make_mesh
    from ..launch.train import make_sharded_state, make_sharded_step
    from ..models import build_model
    from ..models.api import ShapeSpec
    from ..models.zoo import train_input_specs
    from ..optim import AdamWConfig, build_opt_shardings
    from ..roofline.analysis import (
        HW, measure_step, model_flops_decode, model_flops_train,
    )
    from ..sharding import batch_shardings, param_shardings
    from ..sharding.rules import spec_axes
    from ..sharding.spmd import place
    from ..tree import leaves, unflatten

    timings: dict[str, float] = {}
    t0 = time.time()
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    shape = next(s for s in cfg.shapes() if s.name == shape_name)
    name = shape_name
    if batch or seq:
        shape = ShapeSpec(shape.name, seq or shape.seq_len, batch or shape.global_batch,
                          shape.kind)
        name = f"{shape_name}@{shape.global_batch}x{shape.seq_len}"
    axes = ("data", "model") if len(shape_mesh) == 2 else ("pod", "data", "model")
    mesh = make_mesh(shape_mesh, axes, device_type="cpu")
    data_axes = axes[:-1]
    chips = math.prod(shape_mesh)
    if opt_flags.get("batch_over_model") in _TRUE:
        # pure-DP experiment: the 'model' axis joins the batch axes
        data_axes = (*data_axes, "model")

    if opt_flags.get("moe_capacity"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(opt_flags["moe_capacity"])))
    if opt_flags.get("remat") is not None:
        cfg = dataclasses.replace(cfg, remat=opt_flags["remat"] in _TRUE)
    ep_all = opt_flags.get("ep_all") in _TRUE
    if ep_all:
        cfg = dataclasses.replace(cfg, ep_over_data=True)
    replicate_patterns = tuple(opt_flags["replicate_patterns"].split(",")) \
        if opt_flags.get("replicate_patterns") else ()

    params = build_model(cfg).init(0, "meta")
    # FSDP as the rules decide it for the whole model, unless forced
    probe = param_shardings(params, mesh)
    use_fsdp = any(a != "model" for sh in leaves(probe) for e in sh.spec
                   for a in spec_axes(e))
    print(f"fsdp={use_fsdp}")
    fsdp = use_fsdp if opt_flags.get("fsdp") is None else opt_flags["fsdp"] in _TRUE
    p_sh = param_shardings(params, mesh, force_fsdp=fsdp,
                           replicate_patterns=replicate_patterns,
                           expert_axes=(*data_axes, "model") if ep_all else None)
    spec = build_model(cfg, mesh=mesh, data_axes=data_axes)

    if shape.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=torch.bfloat16 if "671b" in arch
                              else torch.float32)
        compress = opt_flags.get("compress_grads") in _TRUE
        o_sh = build_opt_shardings(params, p_sh, mesh)
        state = make_sharded_state(opt_cfg, params, p_sh, o_sh, compression=compress)
        inputs = train_input_specs(cfg, shape)
        b_sh = batch_shardings(inputs, mesh, data_axes)
        inputs = {k: place(v, b_sh[k]) for k, v in inputs.items()}
        step = make_sharded_step(spec, opt_cfg, mesh, p_sh, o_sh, b_sh,
                                 compression=compress, data_axes=data_axes)
        args = (state, inputs)
    else:
        placed = unflatten(params, [place(w, sh) for w, sh in zip(leaves(params),
                                                                  leaves(p_sh))])
        inputs = train_input_specs(cfg, shape)
        inputs.pop("labels")
        if shape.kind == "prefill":
            @torch.no_grad()
            def step(p, b):
                return spec.prefill(p, b if cfg.family == "audio" else b["tokens"],
                                    shape.seq_len)

            args = (placed, inputs)
        else:
            caches = spec.make_caches(placed, shape.global_batch, shape.seq_len)
            token = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")

            @torch.no_grad()
            def step(p, t, c):
                # the last slot: attention over every slot of the cache
                return spec.decode_step(p, t, c, shape.seq_len - 1)

            args = (placed, token, caches)
    del params
    timings["build_s"] = round(time.time() - t0, 1)

    t0 = time.time()
    counts = measure_step(step, *args)
    timings["run_s"] = round(time.time() - t0, 1)

    if shape.kind == "train":
        model_flops = model_flops_train(cfg, shape)
    elif shape.kind == "prefill":
        model_flops = model_flops_train(cfg, shape) / 3.0  # fwd only
    else:
        model_flops = model_flops_decode(cfg, shape)

    hw = HW()
    flops, hbm_bytes = counts.flops, counts.hbm_bytes
    coll_by_kind = dict(counts.collectives.bytes_by_kind)
    coll_total = float(sum(coll_by_kind.values()))
    t_compute = flops / hw.peak_flops
    t_memory = hbm_bytes / hw.hbm_bw
    t_collective = coll_total / hw.ici_bw
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_collective}
    bottleneck = max(terms, key=terms.get)
    bound = max(terms.values())
    param_bytes = sum(d.to_local().numel() * d.to_local().element_size()
                      for d in leaves(args[0]["params"] if shape.kind == "train" else args[0]))

    return {
        "arch": arch,
        "shape": name,
        "mesh": mesh_name(shape_mesh),
        "chips": chips,
        "ok": True,
        **timings,
        "cost_method": "direct (every layer run)",
        "hlo_flops_per_dev": flops,
        "hlo_bytes_per_dev": hbm_bytes,
        "collective_bytes_per_dev": coll_total,
        "collectives": coll_by_kind,
        "collective_counts": dict(counts.collectives.count_by_kind),
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_collective": t_collective,
        "bottleneck": bottleneck,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / (flops * chips) if flops else 0.0,
        "mfu_upper_bound": (
            model_flops / (chips * hw.peak_flops * bound) if bound else 0.0
        ),
        "arg_bytes_per_dev": counts.arg_bytes,
        "temp_bytes_per_dev": counts.peak_bytes - counts.arg_bytes,
        "out_bytes_per_dev": counts.out_bytes,
        "peak_bytes_per_dev": counts.peak_bytes,
        "param_bytes_per_dev": param_bytes,
        "fsdp": fsdp,
        "reduced": reduced,
    }


def _cell_id(arch, shape, mesh):
    kind = {"16x16": "single", "2x16x16": "multi"}.get(mesh, mesh)
    return f"{arch}__{shape}__{kind}"


def _persist(results_dir, result):
    os.makedirs(results_dir, exist_ok=True)
    cid = _cell_id(result["arch"], result["shape"], result["mesh"])
    with open(os.path.join(results_dir, cid + ".json"), "w") as f:
        json.dump(result, f, indent=2)


def run_all(results_dir: str, *, timeout_s: int = 1800, only_arch: str | None = None):
    """Subprocess-per-cell sweep (resumable; finished cells skipped)."""
    import subprocess

    from ..configs import all_configs

    cells = []
    for arch, cfg in all_configs().items():
        if only_arch and arch != only_arch:
            continue
        for shape in cfg.shapes():
            for multi in (False, True):
                cells.append((arch, shape.name, multi))
    print(f"{len(cells)} cells")
    failures = []
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for arch, shape, multi in cells:
        mesh = "2x16x16" if multi else "16x16"
        cid = _cell_id(arch, shape, mesh)
        out = os.path.join(results_dir, cid + ".json")
        if os.path.exists(out):
            print(f"skip (done): {cid}")
            continue
        cmd = [
            sys.executable, "-m", "repro_torch.launch.dryrun",
            "--arch", arch, "--shape", shape, "--results", results_dir,
        ] + (["--multi-pod"] if multi else [])
        print(f"=== {cid}")
        t0 = time.time()
        try:
            proc = subprocess.run(
                cmd, timeout=timeout_s, capture_output=True, text=True,
                env={**os.environ, "PYTHONPATH": src},
            )
            if proc.returncode != 0:
                failures.append(cid)
                err = {"arch": arch, "shape": shape, "mesh": mesh,
                       "ok": False, "error": proc.stderr[-4000:]}
                with open(out, "w") as f:
                    json.dump(err, f, indent=2)
                print(f"FAILED ({time.time()-t0:.0f}s): see {out}")
            else:
                print(f"ok ({time.time()-t0:.0f}s)")
        except subprocess.TimeoutExpired:
            failures.append(cid)
            with open(out, "w") as f:
                json.dump({"arch": arch, "shape": shape, "ok": False,
                           "error": f"timeout {timeout_s}s"}, f)
            print("TIMEOUT")
    print(f"done; {len(failures)} failures: {failures}")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--only-arch")
    ap.add_argument("--results", default="results/dryrun")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--set", action="append", default=[],
                    help="experiment knob key=val (e.g. --set moe_capacity=1.0)")
    ap.add_argument("--mesh", help="mesh shape instead of the production one, "
                                   "e.g. 2x2x2 ([pod x] data x model)")
    ap.add_argument("--batch", type=int, help="global batch instead of the shape's")
    ap.add_argument("--seq", type=int, help="sequence length instead of the shape's")
    ap.add_argument("--reduced", action="store_true", help="the config's reduced()")
    args = ap.parse_args(argv)
    opt_flags = dict(kv.split("=", 1) for kv in args.set)
    if args.all:
        fails = run_all(args.results, timeout_s=args.timeout, only_arch=args.only_arch)
        sys.exit(1 if fails else 0)
    try:
        run_cell(args.arch, args.shape, args.multi_pod, args.results,
                 opt_flags=opt_flags,
                 mesh_shape=tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None,
                 batch=args.batch, seq=args.seq, reduced=args.reduced)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
