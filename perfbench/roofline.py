"""The table of peaks and the least time of one executor call.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): HBM 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s. A card
set below 700 W is slower; every result names the card and the benchmark
reports its power limit beside the numbers in PERF.md.

``executor_bound`` is ``chip_smoke.py``'s ``bound()``, copied: every input
byte read once, the dense trace [C, pes, B] that ``cgra_run`` returns written
once, the per-node tables read once, or the firings at the float32 rate,
whichever is slower. It counts the trace that the API returns, whatever
computes it: a change to what ``cgra_run`` returns needs this count redone.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: The executor's per-node tables: step_ptr, pe, op, t0, src_pe[2],
#: src_delta[2], imm, in_slot; 4 bytes each (step_ptr has II + 1 entries).
_TABLE_WORDS_PER_NODE = 9


def executor_bound(*, num_cycles: int, num_pes: int, batch: int, num_iters: int,
                   num_inputs: int, num_nodes: int, ii: int) -> tuple[float, str]:
    """Least seconds one ``cgra_run`` of this shape can take, and what
    bounds it (``bytes`` or ``operations``)."""
    trace_bytes = num_cycles * num_pes * batch * 4
    input_bytes = num_inputs * num_iters * batch * 4
    table_bytes = (num_nodes * _TABLE_WORDS_PER_NODE + ii + 1) * 4
    by_bytes = (trace_bytes + input_bytes + table_bytes) / HBM_BYTES_PER_S
    by_ops = num_nodes * num_iters * batch / F32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
