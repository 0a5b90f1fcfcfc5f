"""Batched functional execution of a mapped CGRA program on the GPU.

Executes the steady-state modulo schedule produced by the mapper on a PE
grid, vectorised over a batch of independent loop instances (the same
accelerated loop applied to many data streams). It is the port of the JAX
package's ``kernels/cgra_sim.py::_cgra_sim_kernel``:

* :func:`cgra_sim` is the wrapper of the hand-written CUDA kernel
  ``csrc/cgra_sim.cu``. On a CUDA tensor it launches the kernel or raises;
  on a CPU tensor it runs :func:`cgra_sim_torch`. ``cgra_sim.launches``
  counts the kernel's launches.
* :func:`cgra_sim_torch` is the plain PyTorch version of the same function:
  vectorised over lanes and over the nodes of a step, with a Python loop over
  cycles. The CPU path and the on-card comparisons use it.

Both compute the trace [C, pes, B] of every value each PE produces at each
cycle (0 where nothing fires), bit for bit as the trace-indexed oracle
``kernels/ref.py::cgra_sim_reference`` does: operands are read by index from
the trace, and the op is selected by its opcode. See the CUDA source for
what bounds the kernel on the card.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import obs
from ..core.simulate import OPCODES

NOPS = len(OPCODES)

#: Threads per block of the CUDA kernel (one thread per lane).
BLOCK_THREADS = 64


@dataclass(frozen=True)
class SimTables:
    """Per-node tables of one program, grouped by kernel step.

    Node ``n`` of step ``k`` lies in ``step_ptr[k] <= n < step_ptr[k + 1]``;
    it fires at cycles ``t0[n] + it * ii`` for ``0 <= it < num_iters``.
    Built on the host by :meth:`from_numpy`, which validates every index
    once (``kernels/ops.py::compile_program`` builds a program's), then
    moved whole with :meth:`to`.
    """

    ii: int
    num_pes: int
    num_inputs: int           # input streams the tables index
    schedule_length: int      # max(t0) + 1
    step_ptr: torch.Tensor    # [ii + 1] int32
    pe: torch.Tensor          # [n] int32
    op: torch.Tensor          # [n] int32, OPCODES
    t0: torch.Tensor          # [n] int32, first firing cycle
    src_pe: torch.Tensor      # [n, 2] int32, -1 = no operand
    src_delta: torch.Tensor   # [n, 2] int32, cycles since produced (>= 1)
    imm: torch.Tensor         # [n] float32
    in_slot: torch.Tensor     # [n] int32, input stream slot, -1 = not an input

    TENSOR_FIELDS = ("step_ptr", "pe", "op", "t0", "src_pe", "src_delta", "imm",
                "in_slot")

    @classmethod
    def from_numpy(cls, *, ii: int, num_pes: int, num_inputs: int,
                   **arrays: np.ndarray) -> "SimTables":
        """Validate host arrays named like the tensor fields; ``t0`` must
        hold a node, so the tables describe at least one."""
        a = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        n = len(a["pe"])
        ok = (
            ii >= 1 and n >= 1 and a["step_ptr"].shape == (ii + 1,)
            and a["step_ptr"][0] == 0 and a["step_ptr"][-1] == n
            and bool(np.all(np.diff(a["step_ptr"]) >= 0))
            and all(a[k].shape == (n,) for k in ("pe", "op", "t0", "imm", "in_slot"))
            and all(a[k].shape == (n, 2) for k in ("src_pe", "src_delta"))
            and bool(np.all((a["pe"] >= 0) & (a["pe"] < num_pes)))
            and bool(np.all((a["op"] >= 0) & (a["op"] < NOPS)))
            and bool(np.all(a["t0"] >= 0))
            and bool(np.all((a["src_pe"] >= -1) & (a["src_pe"] < num_pes)))
            and bool(np.all((a["src_pe"] < 0) | (a["src_delta"] >= 1)))
            and bool(np.all((a["in_slot"] >= -1) & (a["in_slot"] < num_inputs)))
            and bool(np.all((a["op"] == OPCODES["input"]) == (a["in_slot"] >= 0)))
        )
        if not ok:
            raise ValueError("malformed cgra_sim tables")
        for k in range(ii):
            lo, hi = a["step_ptr"][k], a["step_ptr"][k + 1]
            if np.any(a["t0"][lo:hi] % ii != k):
                raise ValueError(f"a node of step {k} fires off its step")
        return cls(
            ii=ii, num_pes=num_pes, num_inputs=num_inputs,
            schedule_length=int(a["t0"].max()) + 1,
            **{k: torch.from_numpy(a[k].astype(np.float32 if k == "imm" else np.int32))
               for k in cls.TENSOR_FIELDS},
        )

    def num_cycles(self, num_iters: int) -> int:
        """Cycles of a run of ``num_iters`` iterations: the trace's length."""
        return self.schedule_length + (num_iters - 1) * self.ii

    def to(self, device) -> "SimTables":
        kw = {f.name: getattr(self, f.name) for f in fields(self)}
        for k in self.TENSOR_FIELDS:
            kw[k] = kw[k].to(device)
        return SimTables(**kw)


def _check(tables: SimTables, inputs: torch.Tensor) -> None:
    dev = inputs.device
    for k in SimTables.TENSOR_FIELDS:
        t = getattr(tables, k)
        want = torch.float32 if k == "imm" else torch.int32
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"table {k}: need a contiguous {want} tensor on {dev}, "
                f"got {t.dtype} on {t.device}"
            )
    if inputs.dtype != torch.float32 or not inputs.is_contiguous():
        raise ValueError("inputs must be a contiguous float32 tensor")
    if (inputs.dim() != 3 or inputs.shape[0] != tables.num_inputs
            or inputs.shape[1] < 1 or inputs.shape[2] < 1):
        raise ValueError(
            f"inputs must be [{tables.num_inputs}, num_iters >= 1, B >= 1], "
            f"got {list(inputs.shape)}"
        )


def _library() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared (built on first
    use: importing this module needs no CUDA toolkit)."""
    from . import _build

    lib = _build.load("cgra_sim")
    if lib.cgra_sim_launch.argtypes is None:
        lib.cgra_sim_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.cgra_sim_launch.restype = ctypes.c_int
        lib.cgra_sim_error_string.argtypes = [ctypes.c_int]
        lib.cgra_sim_error_string.restype = ctypes.c_char_p
    return lib


def zero_trace(shape: tuple[int, int, int], device) -> torch.Tensor:
    """A zeroed float32 trace [num_cycles, pes, B] on ``device``, enqueued
    on its current stream under the ``obs`` span ``cgra_sim.fill``."""
    with obs.span("cgra_sim.fill"):
        return torch.zeros(shape, dtype=torch.float32, device=device)


def cgra_sim(tables: SimTables, inputs: torch.Tensor,
             trace: torch.Tensor | None = None) -> torch.Tensor:
    """Run the program over ``inputs`` [num_inputs, num_iters, B] f32;
    returns the trace [tables.num_cycles(num_iters), pes, B] f32 on the
    inputs' device.

    ``trace``, if given, is the trace to write: float32, contiguous, of
    that shape on the inputs' device, and already zeroed (the run writes
    only where a node fires); it is returned. Without it the call makes
    one with :func:`zero_trace`.

    A CUDA tensor launches the CUDA kernel on the current stream (no
    synchronisation); the inputs, the tables and a given trace must be
    ready on that stream. A CPU tensor runs :func:`cgra_sim_torch`'s loop.
    The ``obs`` spans ``cgra_sim.fill`` (the trace's zeros, when the call
    makes them) and ``cgra_sim.launch`` (the kernel's launch, or the loop)
    mark the two steps.
    """
    if inputs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"cgra_sim runs on cuda or cpu, not {inputs.device}")
    _check(tables, inputs)
    _, num_iters, batch = inputs.shape
    num_cycles = tables.num_cycles(num_iters)
    shape = (num_cycles, tables.num_pes, batch)
    if trace is None:
        trace = zero_trace(shape, inputs.device)
    elif (tuple(trace.shape) != shape or trace.dtype != torch.float32
          or trace.device != inputs.device or not trace.is_contiguous()):
        raise ValueError(
            f"trace: need a contiguous float32 tensor {list(shape)} on {inputs.device}, "
            f"got {trace.dtype} {list(trace.shape)} on {trace.device}"
        )
    with obs.span("cgra_sim.launch"):
        if inputs.device.type == "cpu":
            return _simulate_torch(tables, inputs, trace)
        lib = _library()
        with torch.cuda.device(inputs.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.cgra_sim_launch(
                tables.step_ptr.data_ptr(), tables.pe.data_ptr(),
                tables.op.data_ptr(), tables.t0.data_ptr(),
                tables.src_pe.data_ptr(), tables.src_delta.data_ptr(),
                tables.imm.data_ptr(), tables.in_slot.data_ptr(),
                inputs.data_ptr(), trace.data_ptr(),
                tables.ii, tables.num_pes, num_cycles, num_iters, batch,
                BLOCK_THREADS, stream,
            )
    if err != 0:
        raise RuntimeError(
            f"cgra_sim launch failed: {lib.cgra_sim_error_string(err).decode()}"
        )
    cgra_sim.launches += 1
    return trace


cgra_sim.launches = 0


def _mask16(x: torch.Tensor) -> torch.Tensor:
    """(int64)|x| & 0xFFFF, and 0 where |x| >= 2^63 or is NaN (numpy's cast
    on x86 gives that; C leaves it undefined, so it is spelled out)."""
    ax = x.abs()
    return torch.where(ax < 2.0**63, ax, 0.0).to(torch.int64) & 0xFFFF


def _alu(op: int, a: torch.Tensor, b: torch.Tensor, imm: torch.Tensor) -> torch.Tensor:
    """One op over [m, B] operands (``imm`` [m]); same rounding as numpy."""
    name = _OP_NAMES[op]
    if name == "const":
        return imm[:, None].expand_as(a).clone()
    if name in ("load", "store", "mov"):
        return a
    if name in ("add", "phi"):
        return a + b
    if name == "sub":
        return a - b
    if name == "mul":
        return a * b
    if name == "div":
        nz = b != 0
        return torch.where(nz, a / torch.where(nz, b, 1.0), 0.0)
    if name == "min":
        return torch.minimum(a, b)
    if name == "max":
        return torch.maximum(a, b)
    if name == "neg":
        return -a
    if name == "abs":
        return a.abs()
    if name == "cmp":
        return (a > b).to(torch.float32)
    ia, ib = _mask16(a), _mask16(b)
    sh = ib % 8
    if name == "and":
        r = ia & ib
    elif name == "or":
        r = ia | ib
    elif name == "xor":
        r = ia ^ ib
    elif name == "shl":
        r = (ia << sh) & 0xFFFF
    elif name == "shr":
        r = ia >> sh
    elif name == "not":
        r = ~ia & 0xFFFF
    else:
        raise ValueError(f"opcode {op} has no ALU semantics")
    return r.to(torch.float32)


_OP_NAMES = {i: name for name, i in OPCODES.items()}


def cgra_sim_torch(tables: SimTables, inputs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cgra_sim` on any device.

    Per cycle it gathers the operands of the step's firing nodes by index
    from the trace, evaluates each opcode present on its own nodes only, and
    scatters the results into the trace.
    """
    _check(tables, inputs)
    _, num_iters, batch = inputs.shape
    trace = zero_trace((tables.num_cycles(num_iters), tables.num_pes, batch), inputs.device)
    return _simulate_torch(tables, inputs, trace)


def _simulate_torch(tables: SimTables, inputs: torch.Tensor,
                    trace: torch.Tensor) -> torch.Tensor:
    """:func:`cgra_sim_torch`'s loop into ``trace``, zeros of the trace's
    shape on the inputs' device."""
    dev = inputs.device
    num_cycles, _, batch = trace.shape
    num_iters = inputs.shape[1]
    ii = tables.ii
    last = (num_iters - 1) * ii
    ptr = tables.step_ptr.tolist()
    host = {k: getattr(tables, k).cpu() for k in ("op", "t0")}
    steps = []
    for k in range(ii):
        lo, hi = ptr[k], ptr[k + 1]
        sl = slice(lo, hi)
        ops = host["op"][sl]
        steps.append(dict(
            t0=host["t0"][sl].tolist(),
            pe=tables.pe[sl].long(),
            src_pe=tables.src_pe[sl].long().clamp(min=0),
            has_src=tables.src_pe[sl] >= 0,
            delta=tables.src_delta[sl].long(),
            imm=tables.imm[sl],
            in_slot=tables.in_slot[sl].long(),
            groups=[(int(o), torch.nonzero(ops == o).flatten().tolist())
                    for o in torch.unique(ops).tolist()],
        ))
    for c in range(num_cycles):
        st = steps[c % ii]
        fire = [i for i, t0 in enumerate(st["t0"]) if t0 <= c <= t0 + last]
        if not fire:
            continue
        idx = torch.tensor(fire, device=dev)
        src_c = c - st["delta"][idx]                          # [m, 2]
        ok = st["has_src"][idx] & (src_c >= 0)
        ab = trace[src_c.clamp(min=0), st["src_pe"][idx]]     # [m, 2, B]
        ab = torch.where(ok[..., None], ab, 0.0)
        val = torch.empty((len(fire), batch), dtype=torch.float32, device=dev)
        pos = {n: j for j, n in enumerate(fire)}
        for op, members in st["groups"]:
            rows = [pos[n] for n in members if n in pos]
            if not rows:
                continue
            r = torch.tensor(rows, device=dev)
            if op == OPCODES["input"]:
                it = (c - torch.tensor([st["t0"][fire[j]] for j in rows],
                                       device=dev)) // ii
                val[r] = inputs[st["in_slot"][idx[r]], it]
            else:
                val[r] = _alu(op, ab[r, 0], ab[r, 1], st["imm"][idx[r]])
        trace[c, st["pe"][idx]] = val
    return trace
