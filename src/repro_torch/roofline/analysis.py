"""Roofline analysis of a step run on ``meta`` tensors (no hardware needed).

The PyTorch counterpart of the JAX package's ``src/repro/roofline/analysis.py``.
Three terms per (arch x shape x mesh), in seconds, for one device:

    compute    = FLOPs / peak_FLOPs
    memory     = bytes / HBM_bw
    collective = sum over collective ops of wire bytes / link_bw

The reference reads FLOPs and bytes from XLA's cost analysis of the compiled,
partitioned module and parses its collectives from the optimized HLO text.
This package compiles no module: :func:`analyze_step` runs the step once,
eagerly, on ``meta`` tensors (shapes and dtypes only; nothing is allocated)
and counts what it dispatches:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, plus what the
  hand-written kernels' meta paths report through :func:`add_kernel_work`
  (the flash kernels' products, which no aten op carries);
* bytes: the input and output bytes of every aten op dispatched, op by op
  and with no fusion (views, and allocations that write nothing, count 0).
  This is an upper estimate of what an eager step moves, and differs by
  definition from XLA's post-fusion ``bytes accessed``;
* collectives: :func:`record_collectives`, the output bytes of every
  ``torch.distributed`` collective times its ring wire factor, under the
  reference's kind names;
* the peak: the bytes of the step's arguments plus those of every storage
  the step creates, each counted from the op that makes it until it is
  freed; its largest value is ``per_device_hbm_peak``.

:class:`HW` holds one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3, and 50 GB/s
for collectives: one 400 Gb/s network card per GPU, because an axis of 16
GPUs spans two 8-GPU nodes and its ring crosses the network.
"""

from __future__ import annotations

import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack


@dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12       # bf16 dense tensor-core FLOP/s / GPU
    hbm_bw: float = 3.35e12          # bytes/s / GPU (HBM3)
    ici_bw: float = 50e9             # bytes/s / GPU (one 400 Gb/s NIC)


@dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int] = field(default_factory=dict)
    count_by_kind: dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


_WIRE_FACTOR = {
    # ring algorithms: wire bytes per device relative to the tensor size
    "all-reduce": 2.0,        # reduce-scatter + all-gather phases
    "all-gather": 1.0,        # (n-1)/n ~= 1
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

#: ``torch.distributed``'s collective ops (``c10d::``) by the reference's
#: kind; each takes its output tensors (in place) as its first argument. A
#: point-to-point receive is the port's collective-permute (the send
#: carries no output of its own).
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
}


def _tensors(x) -> list[torch.Tensor]:
    """The tensors in a nest of lists, tuples and dicts (a DTensor as its
    local shard)."""
    if isinstance(x, torch.Tensor):
        return [getattr(x, "_local_tensor", x)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class _CollectiveRecorder(TorchDispatchMode):
    def __init__(self, stats: CollectiveStats):
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = (_C10D_KINDS.get(func._overloadpacket.__name__)
                if func.namespace == "c10d" else None)
        if kind is not None:
            wire = int(_nbytes(_tensors(args[0])) * _WIRE_FACTOR[kind])
            s = self.stats
            s.bytes_by_kind[kind] = s.bytes_by_kind.get(kind, 0) + wire
            s.count_by_kind[kind] = s.count_by_kind.get(kind, 0) + 1
        return func(*args, **(kwargs or {}))


@contextmanager
def record_collectives():
    """``with record_collectives() as stats:`` sums the wire bytes (output
    bytes x the ring factor) and counts of every ``torch.distributed``
    collective issued inside, by kind, into ``stats``
    (a :class:`CollectiveStats`)."""
    stats = CollectiveStats()
    with _CollectiveRecorder(stats):
        yield stats


def add_kernel_work(flops: float, nbytes: float) -> None:
    """A hand-written kernel's work on meta tensors (its FLOPs, and the
    bytes it reads and writes once), added to every step measurement
    running now (the :func:`measure_step` counters on the dispatch mode
    stack); no-op outside one."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, _OpCounter):
            mode.kernel_flops += flops
            mode.bytes += nbytes


#: allocations that write nothing
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


class _OpCounter(TorchDispatchMode):
    """Bytes read and written per aten op, and live storage bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.kernel_flops = 0.0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, weakref.ref] = {}

    def track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in self._refs:
                continue
            n = st.nbytes()
            self._refs[key] = weakref.ref(st, lambda _, k=key, n=n: self._release(k, n))
            self.live += n
        self.peak = max(self.peak, self.live)

    def _release(self, key: int, n: int) -> None:
        self._refs.pop(key, None)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            return out
        outs = _tensors(out)
        name = func._overloadpacket.__name__
        if not func.is_view and name not in _NO_WRITE:
            self.bytes += _nbytes(_tensors(args) + _tensors(kwargs or {})) + _nbytes(outs)
        self.track(outs)
        return out


@dataclass
class StepCounts:
    """What :func:`measure_step` counted over one run of a step."""

    flops: float
    hbm_bytes: float
    collectives: CollectiveStats
    arg_bytes: int          # the step's arguments
    peak_bytes: int         # arguments + the most the step held at once
    out_bytes: int          # the step's outputs
    result: Any


def measure_step(fn, *args) -> StepCounts:
    """Run ``fn(*args)`` once under the counters (see the module
    docstring); on ``meta`` tensors it allocates nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = _OpCounter()
    counter.track(_tensors(args))
    arg_bytes = counter.live
    flop_mode = FlopCounterMode(display=False)
    with flop_mode, record_collectives() as coll, counter:
        result = fn(*args)
    outs = {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in _tensors(result)}
    return StepCounts(flops=float(flop_mode.get_total_flops() + counter.kernel_flops),
                      hbm_bytes=float(counter.bytes), collectives=coll,
                      arg_bytes=arg_bytes, peak_bytes=counter.peak,
                      out_bytes=sum(outs.values()), result=result)


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    chips: int
    hw: HW
    collectives: CollectiveStats | None = None
    per_device_hbm_peak: float | None = None

    @property
    def t_compute(self) -> float:
        # the counts are one device's (its shards' step): divide by a
        # single device's peak
        return self.flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        # per-device wire bytes (already ring-factor adjusted) over one
        # device's link bandwidth — conservative single-link serialisation
        return self.collective_bytes / self.hw.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def mfu_upper_bound(self, model_flops: float) -> float:
        """Fraction of peak the *useful* model FLOPs could reach if the run
        takes exactly the dominant roofline term."""
        if self.bound_time == 0:
            return 0.0
        return model_flops / (self.chips * self.hw.peak_flops * self.bound_time)


def analyze_step(fn, *args, chips: int, hw: HW = HW()) -> Roofline:
    """Roofline of one device's run of ``fn(*args)`` (a step on this
    rank's shards, on ``meta`` tensors), the counterpart of the reference's
    ``analyze_compiled``."""
    c = measure_step(fn, *args)
    return Roofline(
        flops=c.flops,
        hbm_bytes=c.hbm_bytes,
        collective_bytes=float(c.collectives.total_bytes),
        chips=chips,
        hw=hw,
        collectives=c.collectives,
        per_device_hbm_peak=float(c.peak_bytes),
    )


def model_flops_train(cfg, shape) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE), D = tokens processed."""
    n_active = active_param_count(cfg)
    tokens = shape.global_batch * shape.seq_len
    return 6.0 * n_active * tokens


def model_flops_decode(cfg, shape) -> float:
    """Decode processes global_batch tokens (one step)."""
    return 6.0 * active_param_count(cfg) * shape.global_batch


def active_param_count(cfg) -> int:
    """Active (per-token) parameter count from the architecture config."""
    d, v, L = cfg.d_model, cfg.vocab, cfg.num_layers
    hd = cfg.resolved_head_dim
    total = 2 * v * d if not cfg.tie_embeddings else v * d
    n_dense = cfg.num_dense_layers if cfg.moe else L
    n_moe = L - n_dense if cfg.moe else 0

    if cfg.mla is not None:
        m = cfg.mla
        attn = (
            d * m.q_lora + m.q_lora * cfg.num_heads * (m.qk_nope_dim + m.rope_dim)
            + d * (m.kv_lora + m.rope_dim)
            + m.kv_lora * cfg.num_heads * (m.qk_nope_dim + m.v_dim)
            + cfg.num_heads * m.v_dim * d
        )
    else:
        attn = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd + cfg.num_heads * hd * d

    def mlp_params(ff, gated=True):
        return (3 if gated else 2) * d * ff

    dense_mlp = mlp_params(cfg.d_ff, cfg.mlp_kind != "gelu") if cfg.d_ff else 0
    total += n_dense * (attn + dense_mlp)
    if cfg.moe:
        active_experts = cfg.moe.top_k + cfg.moe.num_shared
        total += n_moe * (attn + active_experts * mlp_params(cfg.moe_d_ff))
    if cfg.ssm is not None or cfg.family in ("ssm", "hybrid"):
        total += L * 4 * d * d  # mixer projections (approximate)
    return int(total)
