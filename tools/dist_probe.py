#!/usr/bin/env python3
"""Which torch.distributed collectives carry CUDA tensors on one GPU.

    python3 tools/dist_probe.py [--ranks 4] [--device cuda|cpu]

Spawns ``--ranks`` processes over the gloo backend, all on one device (NCCL
refuses two ranks on one GPU), and tries each collective that the sharded
training path could use on tensors of that device: ``all_reduce``,
``all_gather`` (a list), ``all_gather_into_tensor`` (f32 and int8),
``reduce_scatter_tensor``, ``all_to_all_single`` and ``broadcast``, then a
``("data", "model")`` ``DeviceMesh`` from ``init_device_mesh`` and a DTensor
round trip (``from_local``, ``redistribute`` to ``Replicate``,
``full_tensor``). Then one process initialises NCCL at world size 1 and
all-reduces. Prints one JSON object: for each probe ``"ok"``, the error's
first line, or that it never returned (a hang: the ranks are then killed).
Exits 0 whatever the verdicts. ``--log-dir`` keeps each rank's progress
with timestamps.

On the H100 machine (torch 2.11.0+cu128) every collective above carries
CUDA tensors over gloo, and ``init_device_mesh("cuda")`` works, but the
DTensor round trip never returns; ``sharding/spmd.py`` therefore moves
shards with ``all_reduce`` and ``all_gather`` itself.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing as mp
import os
import queue
import socket
import sys
import traceback

TIMEOUT_S = 30


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _first_line(e: BaseException) -> str:
    text = f"{type(e).__name__}: {e}".strip()
    return text.splitlines()[0][:300]


def _gloo_rank(rank: int, world: int, port: int, device: str, out, log_dir) -> None:
    import time

    import torch
    import torch.distributed as dist

    results = {}
    log = open(os.path.join(log_dir, f"rank{rank}.log"), "w") if log_dir else None
    t0 = time.perf_counter()

    def note(what):
        if log:
            log.write(f"{time.perf_counter() - t0:8.2f} s  {what}\n")
            log.flush()

    try:
        note(f"init gloo, device {device}, GLOO_SOCKET_IFNAME="
             f"{os.environ.get('GLOO_SOCKET_IFNAME')}")
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        note("initialised")
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            torch.ones(1, device=dev)
            note("cuda context")

        def probe(name, fn):
            note(f"{name} ...")
            out.put((rank, name, "started"))
            try:
                fn()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                results[name] = "ok"
            except Exception as e:  # a verdict, not a failure of the probe
                results[name] = _first_line(e)
            note(f"{name}: {results[name]}")
            out.put((rank, name, results[name]))

        def all_reduce():
            t = torch.full((4,), float(rank), device=dev)
            dist.all_reduce(t)
            assert t.tolist() == [float(sum(range(world)))] * 4, t.tolist()

        def all_reduce_bf16():
            t = torch.full((4,), float(rank), device=dev, dtype=torch.bfloat16)
            dist.all_reduce(t)
            assert t.float().tolist() == [float(sum(range(world)))] * 4, t.tolist()

        def all_reduce_cpu():
            t = torch.full((4,), float(rank))
            dist.all_reduce(t)
            assert t.tolist() == [float(sum(range(world)))] * 4, t.tolist()

        def all_gather_list():
            t = torch.full((2,), float(rank), device=dev)
            outs = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(outs, t)
            assert [o[0].item() for o in outs] == list(map(float, range(world)))

        def all_gather_into(dtype):
            def run():
                t = torch.full((2,), rank, device=dev, dtype=dtype)
                o = torch.empty(2 * world, device=dev, dtype=dtype)
                dist.all_gather_into_tensor(o, t)
                assert o[::2].tolist() == list(range(world)), o.tolist()
            return run

        def reduce_scatter():
            t = torch.arange(world * 2, device=dev, dtype=torch.float32)
            o = torch.empty(2, device=dev)
            dist.reduce_scatter_tensor(o, t)
            assert o.tolist() == [float(world * 2 * rank), float(world * (2 * rank + 1))]

        def all_to_all():
            t = torch.full((world,), float(rank), device=dev)
            o = torch.empty_like(t)
            dist.all_to_all_single(o, t)
            assert o.tolist() == list(map(float, range(world)))

        def broadcast():
            t = torch.full((3,), float(rank), device=dev)
            dist.broadcast(t, 0)
            assert t.tolist() == [0.0] * 3

        probe("all_reduce_cpu_tensor", all_reduce_cpu)
        probe("barrier", dist.barrier)
        probe("all_reduce", all_reduce)
        probe("all_reduce_bf16", all_reduce_bf16)
        probe("all_gather", all_gather_list)
        probe("all_gather_into_tensor", all_gather_into(torch.float32))
        probe("all_gather_into_tensor_int8", all_gather_into(torch.int8))
        probe("reduce_scatter_tensor", reduce_scatter)
        probe("all_to_all_single", all_to_all)
        probe("broadcast", broadcast)
        if world == 4:
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import DTensor, Replicate, Shard

            state = {}

            def mesh():
                state["mesh"] = init_device_mesh(dev.type, (2, 2),
                                                 mesh_dim_names=("data", "model"))
                g = state["mesh"].get_group("model")
                t = torch.ones(1, device=dev)
                dist.all_reduce(t, group=g)
                assert t.item() == 2.0

            def dtensor():
                m = state["mesh"]
                local = torch.full((2, 3), float(rank), device=dev)
                d = DTensor.from_local(local, m, [Shard(0), Shard(1)], run_check=False)
                full = d.redistribute(m, [Replicate(), Replicate()]).to_local()
                assert full.shape == (4, 6)
                assert torch.equal(d.full_tensor(), full)

            probe("init_device_mesh", mesh)
            if "mesh" in state:
                probe("dtensor_redistribute", dtensor)
        dist.destroy_process_group()
    except Exception:
        out.put((rank, "fatal", traceback.format_exc()[-600:]))
    out.put((rank, None, None))


def _nccl_world_one(port: int, out) -> None:
    import torch
    import torch.distributed as dist

    try:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        t = torch.ones(3, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        dist.destroy_process_group()
        out.put("ok")
    except Exception as e:
        out.put(_first_line(e))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-dir", default=None,
                    help="each rank writes its progress to <dir>/rank<r>.log")
    args = ap.parse_args(argv)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    import torch

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_gloo_rank, args=(r, args.ranks, port, args.device, out, args.log_dir))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    verdict = {"torch": torch.__version__, "cuda": torch.version.cuda,
               "device": args.device, "ranks": args.ranks}
    got = {r: {} for r in range(args.ranks)}
    done = set()
    while len(done) < args.ranks:
        try:
            rank, name, res = out.get(timeout=TIMEOUT_S * 2)
        except queue.Empty:
            break
        if name is None:
            done.add(rank)
        else:
            got[rank][name] = res
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()
    for res in got.values():     # a probe that never returned hung
        for name, v in res.items():
            if v == "started":
                res[name] = f"no return within {TIMEOUT_S * 2} s (hung)"
    verdict["gloo"] = got[0]
    verdict["ranks_agree"] = all(got[r] == got[0] for r in got)
    if args.device == "cuda" and torch.cuda.is_available():
        q = ctx.Queue()
        p = ctx.Process(target=_nccl_world_one, args=(free_port(), q))
        p.start()
        try:
            verdict["nccl_world_1"] = q.get(timeout=TIMEOUT_S * 2)
        except Exception as e:
            verdict["nccl_world_1"] = _first_line(e)
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()
    print(json.dumps(verdict, indent=1))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    sys.exit(main())
