"""Compile the full 17-benchmark suite (paper §V) through the compiler API,
then run every mapping batched through the ``cgra_sim`` kernel.

    PYTHONPATH=src python examples/compile_suite_torch.py [size] [--jobs N]
        [--cache-dir DIR] [--joint] [--arch PRESET|FILE.json]
        [--profile fast|quality|deterministic-ci] [--device cpu]

The PyTorch twin of ``examples/compile_suite.py``: one
:class:`repro_torch.api.Compiler` session maps the whole suite via
``compile_batch`` (N worker processes when ``--jobs N``); with
``--cache-dir`` a second run is served from the persistent mapping cache
instead of re-solving. ``--joint`` additionally times the SAT-MapIt-style
joint baseline per kernel (needs z3). ``--arch`` targets a heterogeneous
architecture spec instead of the homogeneous ``size×size`` mesh. Each
mapped kernel then runs 64 lanes x 8 iterations through ``cgra_run``, on
CUDA unless ``--device`` names another device (on ``cpu`` the kernel's
plain version), and its trace must equal the plain version's.
"""

import argparse

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api import Compiler, add_cli_args, options_from_args
from repro_torch.core import CGRA
from repro_torch.core.benchsuite import load_suite
from repro_torch.core.simulate import check_equivalence
from repro_torch.kernels.cgra_sim import cgra_sim_torch
from repro_torch.kernels.ops import cgra_run, compile_program, resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("size", type=int, nargs="?", default=5)
ap.add_argument("--joint", action="store_true")
ap.add_argument("--device", default="cuda", help="device of the batched runs (default: cuda)")
add_cli_args(ap)          # --jobs/--cache-dir/--arch/--profile/... (repro_torch.api)
args = ap.parse_args()
options = options_from_args(args)
if options.deadline_s is None:
    options = options.replace(deadline_s=30.0)

if options.arch:
    compiler = Compiler(options=options)
    target = compiler.spec.name
else:
    compiler = Compiler(CGRA(args.size, args.size), options)
    target = f"{args.size}x{args.size}"
suite = load_suite()
jobs = options.jobs if options.jobs is not None else "auto"
print(f"=== {target} CGRA, 17 benchmarks, jobs={jobs} ===")

dfgs = list(suite.values())
# --trace OUT.json records every job's spans — pool workers shard per pid,
# merged into one Perfetto-loadable timeline
with obs.session(getattr(args, "trace_out", None), enable=options.trace):
    batch = compiler.compile_batch(dfgs)

for dfg, r in zip(dfgs, batch):
    if not r.ok:
        print(f"{r.name:16s} n={dfg.num_nodes:3d} FAILED "
              f"({r.failure}: {r.reason})")
        continue
    line = (
        f"{r.name:16s} n={dfg.num_nodes:3d} II={r.ii:3d} "
        f"(mII={r.m_ii:3d}) wall={r.wall_s:6.3f}s [{r.source}]"
    )
    if args.joint:
        from repro_torch.core.baseline import map_dfg_joint

        jb = map_dfg_joint(dfg, compiler.cgra, time_budget_s=60)
        line += (
            f" | joint II={jb.mapping.ii if jb.ok else '--'} "
            f"t={jb.stats.total_s:6.1f}s "
            f"CTR={jb.stats.total_s / max(1e-3, r.wall_s):7.1f}x"
        )
    print(line)

c = batch.cache_counters
print(f"--- batch wall {batch.wall_s:.2f}s on {batch.num_workers} workers: "
      f"{c['solved']} solved, {c['memory_hits']} memory hits, "
      f"{c['disk_hits']} disk hits, {c['failed']} failed")

# functional spot-check of one mapping reconstructed from the batch rows
# (cache hits were validated on read): execute the smallest kernel's mapping
bit = next(r for r in batch if r.name == "bitcount")
assert bit.ok and bit.mapping is not None
check_equivalence(bit.mapping, num_iters=4)
print("functional equivalence spot-check (bitcount): OK")

# every mapping executed batched: the kernel's trace against its plain version
device = resolve_device(args.device)
rng = np.random.default_rng(0)
for r in batch:
    if not r.ok:
        continue
    prog = compile_program(r.mapping)
    inputs = {v: rng.uniform(-4, 4, (8, 64)).astype(np.float32) for v in prog.input_nodes()}
    _, trace = cgra_run(prog, inputs, 8, device=device)
    x = torch.stack([torch.as_tensor(inputs[v], device=device) for v in prog.input_nodes()])
    assert torch.equal(trace, cgra_sim_torch(prog.tables.to(device), x)), r.name
print(f"batched runs on {device}: {sum(r.ok for r in batch)} kernels, 64 lanes x 8 "
      "iterations, traces equal to the plain version's")

