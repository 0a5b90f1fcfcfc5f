"""Program lowering and the batched executor.

``compile_program`` lowers a space-time Mapping (core/mapper.py) once, into
the [II, pes] integer grids of the JAX package's
``kernels/ops.py::compile_program`` (array for array; the oracle in
``ref.py`` reads them) and, from those grids, the per-node ``SimTables``
that the executor reads. The JAX package's one-hot routing and opcode
tables feed only its Pallas kernel and are not built here.

``cgra_run`` executes a compiled program over batched input streams on a
torch device and returns per-store-node outputs and the full trace, through
the CUDA kernel of ``kernels/cgra_sim.py`` on a GPU. The input streams go to
the device as they are ([num_inputs, num_iters, B]); the kernel reads each
input node's value from them at its firing cycle, so the dense
[C, pes, B] injection array of ``build_injection`` is never built on this
path (at 20×20, 325 cycles and 16384 lanes it would take 8.5 GB).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..core.mapper import Mapping
from ..core.simulate import OPCODES, _operands
from .cgra_sim import SimTables, cgra_sim, zero_trace


@dataclass
class CGRAProgram:
    """One mapped loop kernel, lowered once."""

    mapping: Mapping
    ii: int
    ring: int
    num_pes: int
    # [II, pes] grids, the oracle's input (ref.py) and the tables' source
    imm: np.ndarray        # [II, pes] f32
    op_id: np.ndarray      # [II, pes] int32 (-1 = idle)
    node_at: np.ndarray    # [II, pes] int32 (-1 = idle)
    src_pe: np.ndarray     # [II, pes, 2] int32
    src_delta: np.ndarray  # [II, pes, 2] int32 (cycles since operand produced)
    # what the executor reads: per node, grouped by step, on the host
    tables: SimTables

    def input_nodes(self) -> list[int]:
        """Input node ids in stream-slot order (ascending)."""
        dfg = self.mapping.dfg
        return [v for v in dfg.nodes if dfg.ops[v] == "input"]


def compile_program(mapping: Mapping) -> CGRAProgram:
    dfg, cgra, ii = mapping.dfg, mapping.cgra, mapping.ii
    pes = cgra.num_pes
    labels, t_abs, placement = mapping.labels, mapping.t_abs, mapping.placement

    # operand delay: value produced delta cycles before consumption
    deltas: list[list[int]] = [[] for _ in dfg.nodes]
    srcs: list[list[int]] = [[] for _ in dfg.nodes]
    for v in dfg.nodes:
        for e in _operands(dfg, v):
            delta = (t_abs[v] - t_abs[e.src]) + e.distance * ii
            if delta < 1:
                raise AssertionError(f"non-causal operand on edge {e}")
            deltas[v].append(delta)
            srcs[v].append(placement[e.src])
    ring = max((d for ds in deltas for d in ds), default=1)

    imm = np.zeros((ii, pes), np.float32)
    op_id = np.full((ii, pes), -1, np.int32)
    node_at = np.full((ii, pes), -1, np.int32)
    src_pe = np.full((ii, pes, 2), -1, np.int32)
    src_delta = np.zeros((ii, pes, 2), np.int32)

    for v in dfg.nodes:
        k, pe = labels[v], placement[v]
        op_id[k, pe] = OPCODES[dfg.ops[v]]
        node_at[k, pe] = v
        imm[k, pe] = dfg.imms[v]
        for slot, (sp, dl) in enumerate(zip(srcs[v], deltas[v])):
            src_pe[k, pe, slot] = sp
            src_delta[k, pe, slot] = dl

    # the firing nodes step by step, each step's in ascending PE order
    k, pe = np.nonzero(node_at >= 0)
    nodes = node_at[k, pe]
    is_input = np.asarray(dfg.ops) == "input"
    slot_of = np.where(is_input, np.cumsum(is_input) - 1, -1)
    tables = SimTables.from_numpy(
        ii=ii, num_pes=pes, num_inputs=int(is_input.sum()),
        step_ptr=np.concatenate([[0], np.cumsum(np.bincount(k, minlength=ii))]),
        pe=pe, op=op_id[k, pe], t0=np.asarray(t_abs)[nodes],
        src_pe=src_pe[k, pe], src_delta=src_delta[k, pe], imm=imm[k, pe],
        in_slot=slot_of[nodes],
    )
    return CGRAProgram(
        mapping=mapping, ii=ii, ring=ring, num_pes=pes, imm=imm, op_id=op_id,
        node_at=node_at, src_pe=src_pe, src_delta=src_delta, tables=tables,
    )


def num_cycles(program: CGRAProgram, num_iters: int) -> int:
    return program.mapping.schedule_length + (num_iters - 1) * program.ii


def build_injection(
    program: CGRAProgram, inputs: dict[int, np.ndarray], num_iters: int
) -> tuple[np.ndarray, np.ndarray]:
    """Input-node value injection [C, pes, B] and firing mask [C, pes].

    The dense host form of the JAX package; the oracle in ref.py uses it.
    """
    m = program.mapping
    C = num_cycles(program, num_iters)
    batch = next(iter(inputs.values())).shape[1] if inputs else 1
    inj = np.zeros((C, program.num_pes, batch), np.float32)
    active = np.zeros((C, program.num_pes), np.float32)
    for v in m.dfg.nodes:
        pe = m.placement[v]
        for it in range(num_iters):
            c = m.t_abs[v] + it * m.ii
            active[c, pe] = 1.0
            if m.dfg.ops[v] == "input":
                inj[c, pe, :] = inputs[v][it]
    return inj, active


def resolve_device(device=None) -> torch.device:
    """The run's device: CUDA unless the caller names another.

    Asking for CUDA on a machine without a usable GPU raises; nothing
    quietly runs on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host"
        )
    return dev


#: The executor's copy stream of each CUDA device, by device index.
_COPY_STREAMS: dict[int, torch.cuda.Stream] = {}


def _copy_stream(dev: torch.device) -> torch.cuda.Stream:
    """The executor's copy stream on ``dev``, made on first use: a
    non-blocking stream of torch's pool, never the caller's."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = _COPY_STREAMS.get(index)
    if stream is None:
        stream = _COPY_STREAMS.setdefault(index, torch.cuda.Stream(device=index))
    return stream


def _stage(streams: list, shape: tuple[int, int], dev: torch.device) -> torch.Tensor:
    """The host ``streams`` as one float32 tensor [len(streams), *shape] on
    ``dev``, copied through a page-locked block on the current stream.

    Each stream is copied on the host into its row of the block, and its
    row's asynchronous copy to the device is issued at once, so the next
    row's host copy overlaps it. The block comes from torch's caching host
    allocator: pinned once per power-of-two size, and handed out again only
    after the copies recorded on it have ended.
    """
    staged = torch.empty((len(streams), *shape), dtype=torch.float32, device=dev)
    block = torch.empty(staged.shape, dtype=torch.float32, pin_memory=True)
    for src, row, out in zip(streams, block, staged):
        row.copy_(torch.as_tensor(src))
        out.copy_(row, non_blocking=True)
    return staged


def cgra_run(
    program: CGRAProgram,
    inputs: dict,                    # input node -> [num_iters, B] f32
    num_iters: int,
    *,
    device=None,
) -> tuple[dict[int, torch.Tensor], torch.Tensor]:
    """Execute ``program``; returns (store outputs, full trace) as tensors
    on the run's device (CUDA unless ``device`` names another).

    ``inputs`` maps every input node to its streams, numpy arrays or
    tensors of shape [num_iters, B].

    Streams. The trace's zero fill, the kernel, the stores' gather and the
    returned tensors are ordered on the caller's current stream. The fill
    is the call's first device work: it is enqueued once the inputs' nodes
    and shapes are checked. On a CUDA device, when no input is a CUDA
    tensor, the call's host-to-device copies (the tables and the streams)
    then run on the executor's copy stream for that device while the fill
    runs, and the caller's stream waits for them before the kernel; ``obs``
    counts such calls as ``exec.copy_stream_calls``. The streams are staged:
    each is copied on the host into its row of a page-locked block
    [num_inputs, num_iters, B], and the row's asynchronous copy into the
    same row of the device's stacked streams is issued at once, so that it
    overlaps the next row's host copy. The block comes from torch's caching
    host allocator, which pins a block once per power-of-two size and hands
    it out again only after the copies recorded on it have ended. With
    inputs already on the card, and on the CPU, everything runs on the
    caller's stream and nothing is pinned.
    Every host copy out of the caller's buffers has ended when the call
    returns, so the caller may overwrite its host buffers as soon as the
    call returns.

    ``obs`` spans mark its steps, with no work or synchronisation of their
    own: ``exec.run`` the whole call; inside it ``cgra_sim.fill`` (the
    trace's zeros), ``exec.tables`` (``program.tables``' copies to the
    device), ``exec.inputs`` (the streams' copies to the device),
    ``cgra_sim``'s ``cgra_sim.launch``, and ``exec.gather`` (the stores'
    indexing).
    """
    with obs.span("exec.run"):
        dev = resolve_device(device)
        nodes = program.input_nodes()
        if sorted(inputs) != nodes:
            raise ValueError(f"inputs must cover input nodes {nodes}, got {sorted(inputs)}")
        shapes = {tuple(np.shape(inputs[v])) for v in nodes}
        if len(shapes) > 1 or any(len(s) != 2 for s in shapes):
            raise ValueError("every input stream must be [num_iters, B], all alike")
        iters, batch = shapes.pop() if shapes else (num_iters, 1)
        if iters != num_iters:
            raise ValueError(f"input streams hold {iters} iterations, not {num_iters}")
        if num_iters < 1 or batch < 1:
            raise ValueError(f"need num_iters >= 1 and B >= 1, got {num_iters} and {batch}")
        trace = zero_trace((num_cycles(program, num_iters), program.num_pes, batch), dev)
        on_card = any(isinstance(inputs[v], torch.Tensor) and inputs[v].is_cuda
                      for v in nodes)
        copy = _copy_stream(dev) if dev.type == "cuda" and not on_card else None
        with torch.cuda.stream(copy) if copy is not None else contextlib.nullcontext():
            with obs.span("exec.tables"):
                tables = program.tables.to(dev)
            with obs.span("exec.inputs"):
                if copy is not None:
                    stacked = _stage([inputs[v] for v in nodes], (num_iters, batch), dev)
                elif nodes:
                    stacked = torch.stack([torch.as_tensor(inputs[v], dtype=torch.float32,
                                                           device=dev) for v in nodes])
                else:
                    stacked = torch.zeros((0, num_iters, batch), device=dev)
        if copy is not None:
            caller = torch.cuda.current_stream(dev)
            caller.wait_stream(copy)
            for t in (stacked, *(getattr(tables, k) for k in SimTables.TENSOR_FIELDS)):
                t.record_stream(caller)
            obs.incr("exec.copy_stream_calls")
        trace = cgra_sim(tables, stacked, trace=trace)
        with obs.span("exec.gather"):
            m = program.mapping
            outs: dict[int, torch.Tensor] = {}
            for v in m.dfg.nodes:
                if m.dfg.ops[v] == "store":
                    cyc = m.t_abs[v] + torch.arange(num_iters, device=dev) * m.ii
                    outs[v] = trace[cyc, m.placement[v], :]
    return outs, trace
