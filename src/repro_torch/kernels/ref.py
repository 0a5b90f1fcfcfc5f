"""Oracles for the package's kernels.

``reference_attention`` is the direct-softmax oracle of the flash-attention
kernel, a torch copy of the JAX package's ``kernels/ref.py``
``reference_attention``: whole [S, S] score matrices in f32, no tiling, so it
shares no structure with the kernel or its blocked plain version.

``cgra_sim_reference`` is the executor's oracle, in numpy on the host. It
executes the same compiled program as the cgra_sim kernel with
integer-indexed reads from the full value trace and the dense host injection
of ``build_injection``, one (cycle, PE) at a time; it is the JAX package's
``kernels/ref.py::cgra_sim_reference``. Scalar semantics are the ALU of
core.simulate, in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.simulate import OPCODES
from .ops import CGRAProgram, build_injection, num_cycles

_F = np.float32
_NAMES = {v: k for k, v in OPCODES.items()}


def reference_attention(
    q: torch.Tensor,   # [B, Hq, S, D]
    k: torch.Tensor,   # [B, Hkv, S, D]
    v: torch.Tensor,   # [B, Hkv, S, D]
    *,
    sm_scale: float | None = None,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Direct-softmax oracle for kernels/flash_attention.py (f32 math);
    fully masked rows give 0. The output has q's dtype."""
    b, hq, s_len, d = q.shape
    group = hq // k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(s_len, device=q.device)
    q_pos, k_pos = pos[:, None], pos[None, :]
    mask = torch.ones((s_len, s_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows: softmax of all -1e30 is uniform garbage; zero them
    p = torch.where(mask.any(-1)[:, None], p, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def _mask16(x: np.ndarray) -> np.ndarray:
    """(int64)|x| & 0xFFFF; 0 where |x| >= 2^63 or is NaN, which is what
    numpy's unchecked cast gives on x86, spelled out so it holds anywhere."""
    ax = np.abs(x)
    return np.where(ax < _F(2.0**63), ax, _F(0)).astype(np.int64) & 0xFFFF


def _alu_np(op_id: int, a: np.ndarray, b: np.ndarray, imm: float, inj: np.ndarray) -> np.ndarray:
    op = _NAMES[op_id]
    ia = _mask16(a)
    ib = _mask16(b)
    sh = ib % 8
    if op == "input":
        return inj
    if op == "const":
        return np.full_like(a, _F(imm))
    if op in ("load", "store", "mov"):
        return a
    if op == "phi":
        return a + b
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "div":
        return np.where(b != 0, a / np.where(b != 0, b, _F(1)), _F(0)).astype(_F)
    if op == "and":
        return (ia & ib).astype(_F)
    if op == "or":
        return (ia | ib).astype(_F)
    if op == "xor":
        return (ia ^ ib).astype(_F)
    if op == "shl":
        return ((ia << sh) & 0xFFFF).astype(_F)
    if op == "shr":
        return (ia >> sh).astype(_F)
    if op == "min":
        return np.minimum(a, b)
    if op == "max":
        return np.maximum(a, b)
    if op == "neg":
        return -a
    if op == "not":
        return (~ia & 0xFFFF).astype(_F)
    if op == "abs":
        return np.abs(a)
    if op == "cmp":
        return (a > b).astype(_F)
    raise ValueError(op)


def cgra_sim_reference(
    program: CGRAProgram,
    inputs: dict[int, np.ndarray],
    num_iters: int,
    *,
    lanes=None,
) -> tuple[dict[int, np.ndarray], np.ndarray]:
    """Trace-indexed reference execution; returns (store outputs, trace).

    ``lanes`` (indices into the batch) runs only those streams, so a large
    batch can be checked on a sample; the trace then has ``len(lanes)``
    lanes.
    """
    if lanes is not None:
        inputs = {v: np.asarray(x)[:, lanes] for v, x in inputs.items()}
    inj, active = build_injection(program, inputs, num_iters)
    C = num_cycles(program, num_iters)
    pes = program.num_pes
    batch = inj.shape[2]
    trace = np.zeros((C, pes, batch), _F)
    for c in range(C):
        k = c % program.ii
        for pe in range(pes):
            if active[c, pe] == 0.0:
                continue
            oid = int(program.op_id[k, pe])
            ops_ab = []
            for slot in range(2):
                sp = int(program.src_pe[k, pe, slot])
                dl = int(program.src_delta[k, pe, slot])
                if sp < 0 or c - dl < 0:
                    ops_ab.append(np.zeros(batch, _F))
                else:
                    ops_ab.append(trace[c - dl, sp, :])
            val = _alu_np(
                oid, ops_ab[0], ops_ab[1], float(program.imm[k, pe]), inj[c, pe]
            )
            trace[c, pe, :] = val.astype(_F)
    m = program.mapping
    outs: dict[int, np.ndarray] = {}
    for v in m.dfg.nodes:
        if m.dfg.ops[v] == "store":
            cyc = m.t_abs[v] + np.arange(num_iters) * m.ii
            outs[v] = trace[cyc, m.placement[v], :]
    return outs, trace
