"""Quickstart: map a loop DFG onto a CGRA through the ``repro_torch.api``
compiler, validate it by execution, and run it batched through the CUDA
``cgra_sim`` kernel.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --profile deterministic-ci
    PYTHONPATH=src python examples/quickstart_torch.py --cache-dir /tmp/repro-maps
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The PyTorch twin of ``examples/quickstart.py``: resolve a
:class:`repro_torch.api.CompileOptions` (profile + flag overrides, one shared
flag set across every CLI), bind a :class:`repro_torch.api.Compiler` session
to a target, and read the structured :class:`repro_torch.api.CompileResult`.
With ``--cache-dir`` the session exercises the persistent mapping cache
exactly like the batch service does. The batched run goes to CUDA unless
``--device`` names another device; on ``cpu`` it takes the kernel's plain
PyTorch version.
"""

import argparse

import numpy as np

from repro_torch import obs
from repro_torch.api import Compiler, add_cli_args, options_from_args
from repro_torch.core import CGRA, running_example
from repro_torch.core.simulate import check_equivalence
from repro_torch.kernels.ops import cgra_run, compile_program

ap = argparse.ArgumentParser()
add_cli_args(ap)                      # --profile/--cache-dir/--deterministic/...
ap.add_argument("--device", default="cuda",
                help="torch device of the batched run (default: cuda)")
args = ap.parse_args()
options = options_from_args(args)     # THE resolution path (DESIGN.md §11.1)

# 1. the paper's running example: 14-op loop body with two loop-carried deps
dfg = running_example()
compiler = Compiler(CGRA(2, 2), options)

# 2. decoupled mapping: time solution -> monomorphism space solution
# (--trace OUT.json records the compile's span tree, DESIGN.md §15)
with obs.session(getattr(args, "trace_out", None), enable=options.trace):
    result = compiler.compile(dfg)
assert result.ok, result.reason
m = result.mapping
print(m.pretty())
print(
    f"time phase {result.phases.time_s*1e3:.1f} ms, "
    f"space phase {result.phases.space_s*1e3:.1f} ms "
    f"(II={result.ii}, mII={result.m_ii}, source={result.source})"
)

# 3. validate by execution: cycle-accurate modulo-scheduled run == reference
report = check_equivalence(m, num_iters=8)
print(f"functional equivalence OK over {report.cycles} cycles; "
      f"max register pressure {max(report.max_register_pressure.values())}")

# 4. run 256 independent instances of the loop through the cgra_sim kernel
prog = compile_program(m)
rng = np.random.default_rng(0)
inputs = {
    v: rng.uniform(-2, 2, (8, 256)).astype(np.float32)
    for v in dfg.nodes
    if dfg.ops[v] == "input"
}
outs, trace = cgra_run(prog, inputs, num_iters=8, device=args.device)
# read the sink node's stream from the trace (the running example's final op)
sink = max(dfg.nodes, key=lambda v: m.t_abs[v])
cycles = [m.t_abs[sink] + it * m.ii for it in range(8)]
stream = trace[cycles, m.placement[sink], :]
print(f"cgra_sim on {trace.device}: sink node {sink} stream "
      f"{tuple(stream.shape)} (iters x batch); sample: {stream[:3, 0].tolist()}")
