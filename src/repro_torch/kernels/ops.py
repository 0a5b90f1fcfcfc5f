"""Program lowering and the batched executor.

``compile_program`` lowers a space-time Mapping (core/mapper.py) into dense
per-step tables, array for array as the JAX package's
``kernels/ops.py::compile_program`` does (its one-hot routing and opcode
tables included, so the two lowerings can be compared).

``cgra_run`` executes a compiled program over batched input streams on a
torch device and returns per-store-node outputs and the full trace, through
the CUDA kernel of ``kernels/cgra_sim.py`` on a GPU. The input streams go to
the device as they are ([num_inputs, num_iters, B]); the kernel reads each
input node's value from them at its firing cycle, so the dense
[C, pes, B] injection array of ``build_injection`` is never built on this
path (at 20×20, 325 cycles and 16384 lanes it would take 8.5 GB).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..core.mapper import Mapping
from ..core.simulate import OPCODES, _operands
from .cgra_sim import NOPS, SimTables, cgra_sim


@dataclass
class CGRAProgram:
    """Dense encoding of one mapped loop kernel."""

    mapping: Mapping
    ii: int
    ring: int
    num_pes: int
    # one-hot tables, per kernel step
    route_a: np.ndarray    # [II, pes, ring*pes] f32
    route_b: np.ndarray    # [II, pes, ring*pes] f32
    op_sel: np.ndarray     # [II, pes, NOPS] f32
    imm: np.ndarray        # [II, pes] f32
    # integer views (used by ref.py and the executor's tables)
    op_id: np.ndarray      # [II, pes] int32 (-1 = idle)
    node_at: np.ndarray    # [II, pes] int32 (-1 = idle)
    src_pe: np.ndarray     # [II, pes, 2] int32
    src_delta: np.ndarray  # [II, pes, 2] int32 (cycles since operand produced)

    def input_nodes(self) -> list[int]:
        """Input node ids in stream-slot order (ascending)."""
        dfg = self.mapping.dfg
        return [v for v in dfg.nodes if dfg.ops[v] == "input"]

    def sim_tables(self) -> SimTables:
        """The per-node, step-grouped tables the executor reads (host)."""
        m = self.mapping
        slot_of = {v: i for i, v in enumerate(self.input_nodes())}
        order = [(k, pe) for k in range(self.ii) for pe in range(self.num_pes)
                 if self.node_at[k, pe] >= 0]
        counts = np.bincount([k for k, _ in order], minlength=self.ii)
        nodes = [int(self.node_at[k, pe]) for k, pe in order]
        return SimTables.from_numpy(
            ii=self.ii, num_pes=self.num_pes, num_inputs=len(slot_of),
            step_ptr=np.concatenate([[0], np.cumsum(counts)]),
            pe=np.array([pe for _, pe in order]),
            op=np.array([self.op_id[k, pe] for k, pe in order]),
            t0=np.array([m.t_abs[v] for v in nodes]),
            src_pe=np.array([self.src_pe[k, pe] for k, pe in order]).reshape(-1, 2),
            src_delta=np.array([self.src_delta[k, pe] for k, pe in order]).reshape(-1, 2),
            imm=np.array([self.imm[k, pe] for k, pe in order], np.float32),
            in_slot=np.array([slot_of.get(v, -1) for v in nodes]),
        )


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

    route_a = np.zeros((ii, pes, ring * pes), np.float32)
    route_b = np.zeros((ii, pes, ring * pes), np.float32)
    op_sel = np.zeros((ii, pes, NOPS), np.float32)
    imm = np.zeros((ii, pes), np.float32)
    op_id = np.full((ii, pes), -1, np.int32)
    node_at = np.full((ii, pes), -1, np.int32)
    src_pe = np.full((ii, pes, 2), -1, np.int32)
    src_delta = np.zeros((ii, pes, 2), np.int32)

    for v in dfg.nodes:
        k, pe = labels[v], placement[v]
        op = dfg.ops[v]
        op_sel[k, pe, OPCODES[op]] = 1.0
        op_id[k, pe] = OPCODES[op]
        node_at[k, pe] = v
        imm[k, pe] = dfg.imms[v]
        for slot, (sp, dl) in enumerate(zip(srcs[v], deltas[v])):
            # ring slot dl-1 holds the value produced dl cycles ago
            flat = (dl - 1) * pes + sp
            (route_a if slot == 0 else route_b)[k, pe, flat] = 1.0
            src_pe[k, pe, slot] = sp
            src_delta[k, pe, slot] = dl

    return CGRAProgram(
        mapping=mapping, ii=ii, ring=ring, num_pes=pes,
        route_a=route_a, route_b=route_b, op_sel=op_sel, imm=imm,
        op_id=op_id, node_at=node_at, src_pe=src_pe, src_delta=src_delta,
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

    ``obs`` spans mark its steps, with no work or synchronisation of their
    own: ``exec.run`` the whole call; inside it ``exec.tables`` (the host
    tables and their copies to the device), ``exec.inputs`` (the streams'
    copies and their stack), ``cgra_sim``'s ``cgra_sim.fill`` and
    ``cgra_sim.launch``, and ``exec.gather`` (the stores' indexing).
    """
    with obs.span("exec.run"):
        dev = resolve_device(device)
        nodes = program.input_nodes()
        if sorted(inputs) != nodes:
            raise ValueError(f"inputs must cover input nodes {nodes}, got {sorted(inputs)}")
        with obs.span("exec.tables"):
            tables = program.sim_tables().to(dev)
        with obs.span("exec.inputs"):
            streams = [torch.as_tensor(inputs[v], dtype=torch.float32, device=dev)
                       for v in nodes]
            if any(s.shape != streams[0].shape or s.dim() != 2 for s in streams):
                raise ValueError("every input stream must be [num_iters, B], all alike")
            if streams and streams[0].shape[0] != num_iters:
                raise ValueError(f"input streams hold {streams[0].shape[0]} iterations, "
                                 f"not {num_iters}")
            batch = streams[0].shape[1] if streams else 1
            stacked = (torch.stack(streams) if streams
                       else torch.zeros((0, num_iters, batch), device=dev))
        trace = cgra_sim(tables, stacked.contiguous())
        with obs.span("exec.gather"):
            m = program.mapping
            outs: dict[int, torch.Tensor] = {}
            for v in m.dfg.nodes:
                if m.dfg.ops[v] == "store":
                    cyc = m.t_abs[v] + torch.arange(num_iters, device=dev) * m.ii
                    outs[v] = trace[cyc, m.placement[v], :]
    return outs, trace
