"""The benchmark's calls into the port's executor, shared by the drivers.

A batch is what a user of the executor does: host (numpy) streams in,
``kernels/ops.py::cgra_run`` on the device, each store's stream copied back
to the host. The copy waits for the device, so a batch ends when its stores
are on the host.
"""

from __future__ import annotations

import numpy as np

from . import reference


def lower(mapping):
    """The port's lowering of a mapping to the executor's tables."""
    from repro_torch.kernels.ops import compile_program

    return compile_program(mapping)


def run_batch(ctx, program, streams: dict, num_iters: int) -> dict[int, np.ndarray]:
    """One ``cgra_run`` of ``program``; returns its stores on the host."""
    from repro_torch.kernels.ops import cgra_run

    with ctx.span("cgra_run"):
        outs, trace = cgra_run(program, streams, num_iters, device=ctx.device)
    with ctx.span("stores_to_host"):
        stores = {v: out.cpu().numpy() for v, out in outs.items()}
    del outs, trace
    return stores


def store_mismatches(dfg: reference.PlainDFG, streams: dict, stores: dict | None,
                     num_iters: int, *, precision: str = "float32") -> int:
    """Store values of one batch that differ from the plain reference's;
    a batch with no stores (it raised) counts every value."""
    want = reference.interpret(dfg, streams, num_iters, precision=precision)
    if stores is None:
        return sum(int(w.size) for w in want.values())
    return reference.mismatches(stores, want)


def free_device(ctx) -> None:
    if ctx.device == "cuda":
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
