"""Fused flash attention for the LM model zoo on the GPU, forward and backward.

The port of the JAX package's ``kernels/flash_attention.py::_flash_kernel``,
and of the gradient that JAX's autodiff takes of the reference attention:

* :func:`flash_attention` is the wrapper of the hand-written CUDA kernels
  in ``csrc/flash_attention.cu``: a tensor-core kernel (wgmma, TMA) for
  bf16/f16 at D 64, 128, 192 and 256, and a CUDA-core kernel for f32 and
  the other head dims; the source's note says why. It keeps the
  reference's signature (less ``interpret``) and validation. On a CUDA
  tensor it launches a kernel or raises; on a CPU tensor it runs
  :func:`flash_attention_torch`. When grad mode is on and q, k or v
  requires grad, it goes through :class:`_FlashAttention`, whose backward
  is the hand-written kernels of ``csrc/flash_attention_bwd.cu`` on the
  card (on tensor cores for bf16/f16 at D 64, 128 and 256, on CUDA cores
  for f32 and the other head dims; the source's note says why) and
  :func:`flash_attention_backward_torch` on the CPU.
  ``flash_attention.launches`` counts every forward kernel launch,
  ``flash_attention.tensor_core_launches`` those of the tensor-core kernel,
  ``flash_attention.backward_launches`` every backward launch and
  ``flash_attention.tensor_core_backward_launches`` those of the
  tensor-core backward.
* :func:`flash_attention_lse` and :func:`flash_attention_backward` are the
  two halves the Function runs: the forward with each row's log-sum-exp,
  and dq, dk, dv from q, k, v, the log-sum-exp and d out. The backward
  takes no output: each row's ``D = sum_j P dP`` is summed from the
  probabilities it recomputes, where FlashAttention-2 takes ``dO . o``
  from the forward's output. An error in D reaches dq times the keys'
  shared component, which the exact dq does not see, and ``dO . o`` from
  a 16-bit output put dq 22 % of its max off on whisper-small's last
  decoder layer, whose keys share a mean 13 times their spread.
* :func:`flash_attention_torch` is the plain PyTorch version of the
  forward, blocked the same way as the reference kernel: an online softmax
  over kv blocks with f32 running max, denominator and accumulator,
  skipping blocks the masks empty. :func:`flash_attention_backward_torch`
  is the plain version of the backward kernel, blocked the same way. The
  CPU path and the on-card comparisons use them.
* :func:`flash_attention_padded` serves any sequence length on the causal
  path, padding the end up to the block.
* On ``meta`` tensors (the dry-run's, ``launch/dryrun.py``) the three entry
  points return empty outputs of the right shapes and dtypes and report the
  kernel's work, :func:`flash_attention_flops` and the bytes it reads and
  writes once, to ``roofline.analysis.add_kernel_work``: no aten op carries
  the kernel's products, so a FLOP counter would not see them.

Supported variants: causal masking, sliding-window masking (``q - k <
window``), logit soft-capping (``cap * tanh(s / cap)``) and GQA (kv head =
``h // (Hq // Hkv)``). Fully masked rows give 0, a log-sum-exp of -inf and
zero gradients; the output has q's dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30

#: dtype codes of the CUDA kernel's C interface
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _library() -> ctypes.CDLL:
    """The built forward library, its C signatures declared (built on first
    use: importing this module needs no CUDA toolkit)."""
    from . import _build

    lib = _build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_uses_tensor_cores.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_uses_tensor_cores.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    """The built backward library (``csrc/flash_attention_bwd.cu``), its C
    signatures declared; built on first use, like :func:`_library`."""
    from . import _build

    lib = _build.load("flash_attention_bwd")
    if lib.flash_attention_bwd_launch.argtypes is None:
        lib.flash_attention_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float]
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        lib.flash_attention_bwd_uses_tensor_cores.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_bwd_uses_tensor_cores.restype = ctypes.c_int
    return lib


def _blocks(s_len: int, hq: int, hkv: int, block_q: int, block_kv: int):
    """The reference's validation; returns the effective blocks."""
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    bq = min(block_q, s_len)
    bkv = min(block_kv, s_len)
    if s_len % bq or s_len % bkv:
        raise ValueError(f"seq len {s_len} not divisible by blocks {bq},{bkv}")
    return bq, bkv


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    b, hq, s_len, d = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes f32, bf16 or f16, not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must have q's dtype and device "
                             f"({q.dtype}, {q.device}), got {t.dtype}, {t.device}")
        if t.dim() != 4 or t.shape[0] != b or t.shape[2:] != (s_len, d):
            raise ValueError(f"{name} must be [{b}, Hkv, {s_len}, {d}], "
                             f"got {list(t.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {list(k.shape)} and v {list(v.shape)} differ")
    if d % 32 or not 32 <= d <= 256:
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 32 up to 256")
    if b * hq > 65535:
        raise ValueError(f"batch * q heads = {b * hq} exceeds the grid's 65535")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernel's vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _window_args(window: int | None, s_len: int) -> tuple[int, int]:
    """(has_window, window) of the C interfaces: a window >= S never masks;
    one <= -S masks all a window can."""
    has_window = window is not None and window < s_len
    return int(has_window), (max(int(window), -s_len) if has_window else 0)


def _forward_kernel(q, k, v, sm_scale, causal, window, softcap, with_lse):
    """Launch the forward kernel on CUDA tensors; returns (out, lse or
    None). lse is [B * Hq, S] f32: each row's log-sum-exp of its scaled
    (and capped) scores, -inf for a fully masked row."""
    b, hq, s_len, d = q.shape
    _check_cuda(q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = (torch.empty((b * hq, s_len), dtype=torch.float32, device=q.device)
           if with_lse else None)
    has_window, win = _window_args(window, s_len)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            _DTYPES[q.dtype], b, hq, k.shape[1], s_len, d, float(sm_scale),
            int(causal), has_window, win, int(softcap is not None),
            float(softcap or 0.0), stream,
        )
    if err != 0:
        raise RuntimeError(
            "flash_attention launch failed: "
            f"{lib.flash_attention_error_string(err).decode()}"
        )
    flash_attention.launches += 1
    if lib.flash_attention_uses_tensor_cores(_DTYPES[q.dtype], d):
        flash_attention.tensor_core_launches += 1
    return out, lse


def _backward_kernel(q, k, v, lse, do, sm_scale, causal, window, softcap):
    """Launch the backward kernel on CUDA tensors; returns (dq, dk, dv) in
    the inputs' dtype."""
    b, hq, s_len, d = q.shape
    _check_cuda(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do must be like q ({list(q.shape)}, {q.dtype}, {q.device}), "
                         f"got {list(do.shape)}, {do.dtype}, {do.device}")
    if lse.shape != (b * hq, s_len) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be [{b * hq}, {s_len}] float32 on {q.device}, got "
                         f"{list(lse.shape)} {lse.dtype} on {lse.device}")
    q, k, v, do = (_aligned(t) for t in (q, k, v, do))
    lse = _aligned(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the kernels' scratch: each row's D and lse, rows padded to whole tiles
    s_pad = -(-s_len // 64) * 64
    work = torch.empty(2 * b * hq * s_pad, dtype=torch.float32, device=q.device)
    has_window, win = _window_args(window, s_len)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            work.data_ptr(), _DTYPES[q.dtype], b, hq, k.shape[1], s_len, d,
            float(sm_scale), int(causal), has_window, win,
            int(softcap is not None), float(softcap or 0.0), stream,
        )
    if err != 0:
        raise RuntimeError(
            "flash_attention backward launch failed: "
            f"{lib.flash_attention_bwd_error_string(err).decode()}"
        )
    flash_attention.backward_launches += 1
    if lib.flash_attention_bwd_uses_tensor_cores(_DTYPES[q.dtype], d):
        flash_attention.tensor_core_backward_launches += 1
    return dq, dk, dv


def causal_pairs(s_len: int, window: int | None = None) -> int:
    """(query, key) pairs a causal mask leaves, with ``window`` (q - k <
    window) if given."""
    if window is None or window >= s_len:
        return s_len * (s_len + 1) // 2
    return window * (window + 1) // 2 + (s_len - window) * window


def flash_attention_flops(b: int, hq: int, s_len: int, d: int, *, causal: bool = True,
                          window: int | None = None, backward: bool = False) -> int:
    """FLOPs of the forward's two products (q k^T and p v) over the pairs
    the masks leave (every pair without ``causal``); the backward's five
    products are 2.5x that."""
    pairs = causal_pairs(s_len, window) if causal else s_len * s_len
    flops = 4 * b * hq * d * pairs
    return flops * 5 // 2 if backward else flops


def _meta_work(ins, outs, flops: int) -> None:
    from ..roofline.analysis import add_kernel_work

    add_kernel_work(flops, sum(t.numel() * t.element_size() for t in (*ins, *outs)))


def _forward_meta(q, k, v, causal, window, with_lse):
    """The forward on meta tensors: empty outputs, the work reported."""
    b, hq, s_len, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * hq, s_len), dtype=torch.float32, device=q.device)
    _meta_work((q, k, v), (out, lse) if with_lse else (out,),
               flash_attention_flops(b, hq, s_len, d, causal=causal, window=window))
    return out, lse


def flash_attention_lse(q, k, v, *, sm_scale: float, causal: bool = True,
                        window: int | None = None, softcap: float | None = None,
                        block_q: int = 128, block_kv: int = 128):
    """The forward with each row's log-sum-exp: (out [B, Hq, S, D], lse
    [B * Hq, S] f32). CUDA tensors launch the forward kernel; CPU tensors
    run :func:`flash_attention_torch` with the blocks. Records no graph."""
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, sm_scale=sm_scale, causal=causal,
                                     window=window, softcap=softcap, block_q=block_q,
                                     block_kv=block_kv, return_lse=True)
    if q.device.type == "meta":
        return _forward_meta(q, k, v, causal, window, True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _forward_kernel(q, k, v, sm_scale, causal, window, softcap, True)


def flash_attention_backward(q, k, v, lse, do, *, sm_scale: float,
                             causal: bool = True, window: int | None = None,
                             softcap: float | None = None, block_q: int = 128,
                             block_kv: int = 128):
    """dq, dk, dv of :func:`flash_attention` from its inputs, the
    log-sum-exp ``lse`` of :func:`flash_attention_lse` and the output's
    gradient ``do``. CUDA tensors launch the backward kernels (on tensor
    cores for bf16/f16 at D 64, 128 and 256, else on CUDA cores); CPU
    tensors run :func:`flash_attention_backward_torch` with the blocks."""
    if q.device.type == "cpu":
        return flash_attention_backward_torch(
            q, k, v, lse, do, sm_scale=sm_scale, causal=causal, window=window,
            softcap=softcap, block_q=block_q, block_kv=block_kv)
    if q.device.type == "meta":
        grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        b, hq, s_len, d = q.shape
        _meta_work((q, k, v, lse, do), grads, flash_attention_flops(
            b, hq, s_len, d, causal=causal, window=window, backward=True))
        return grads
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _backward_kernel(q, k, v, lse, do, sm_scale, causal, window, softcap)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel with the
    log-sum-exp, then the backward kernel (their plain versions on the CPU).
    Saves q, k, v and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, window, softcap, block_q, block_kv):
        opts = dict(sm_scale=sm_scale, causal=causal, window=window,
                    softcap=softcap, block_q=block_q, block_kv=block_kv)
        out, lse = flash_attention_lse(q, k, v, **opts)
        ctx.save_for_backward(q, k, v, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,   # [B, Hq, S, D]
    k: torch.Tensor,   # [B, Hkv, S, D]
    v: torch.Tensor,   # [B, Hkv, S, D]
    *,
    sm_scale: float | None = None,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    block_q: int = 128,
    block_kv: int = 128,
) -> torch.Tensor:
    """Attention of q over k/v; returns [B, Hq, S, D] in q's dtype.

    Raises ``ValueError`` if Hq is not a multiple of Hkv or S is not
    divisible by ``min(block_q, S)`` and ``min(block_kv, S)``, as the
    reference does. A CUDA tensor launches a CUDA kernel on the current
    stream (no synchronisation), whose own tiling does not depend on the
    blocks: the tensor-core kernel for bf16/f16 at D 64, 128, 192 or 256,
    else the CUDA-core kernel. A CPU tensor runs
    :func:`flash_attention_torch` with the blocks. With grad mode on and an
    input that requires grad, the result comes from :class:`_FlashAttention`
    and carries its gradient.
    """
    b, hq, s_len, d = q.shape
    bq, bkv = _blocks(s_len, hq, k.shape[1], block_q, block_kv)
    if sm_scale is None:
        sm_scale = d ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, float(sm_scale), causal, window,
                                     softcap, bq, bkv)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, sm_scale=sm_scale, causal=causal,
                                     window=window, softcap=softcap,
                                     block_q=bq, block_kv=bkv)
    if q.device.type == "meta":
        return _forward_meta(q, k, v, causal, window, False)[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _forward_kernel(q, k, v, sm_scale, causal, window, softcap, False)[0]


flash_attention.launches = 0
flash_attention.tensor_core_launches = 0
flash_attention.backward_launches = 0
flash_attention.tensor_core_backward_launches = 0


def flash_attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: float | None = None,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    block_q: int = 128,
    block_kv: int = 128,
    return_lse: bool = False,
):
    """Plain PyTorch version of :func:`flash_attention` on any device.

    Query blocks of ``block_q`` rows each run an online softmax over the kv
    blocks of ``block_kv`` keys that their masks leave non-empty, with the
    reference kernel's f32 statistics and its guard for fully masked rows.
    Any S is taken: the last blocks may be short. ``return_lse`` also
    returns each row's log-sum-exp ``m + log(l)`` as [B * Hq, S] f32, -inf
    where the row is fully masked (the forward kernel's ``lse``).
    """
    b, hq, s_len, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    qf = q.float().reshape(b, hkv, group, s_len, d)
    kf, vf = k.float(), v.float()
    pos = torch.arange(s_len, device=q.device)
    out = torch.empty_like(qf)
    lse = torch.empty(qf.shape[:-1], device=q.device)
    for q0 in range(0, s_len, block_q):
        q1 = min(q0 + block_q, s_len)
        lo, hi = _kv_range(q0, q1, s_len, causal, window, block_kv)
        m = torch.full((b, hkv, group, q1 - q0, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, group, q1 - q0, d), device=q.device)
        for k0 in range(lo, hi, block_kv):
            k1 = min(k0 + block_kv, s_len)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qf[:, :, :, q0:q1],
                             kf[:, :, k0:k1]) * sm_scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            qp, kp = pos[q0:q1, None], pos[None, k0:k1]
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kp <= qp
            if window is not None:
                mask &= qp - kp < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            safe = m_new > NEG_INF / 2
            p = torch.where(safe, torch.exp(s - m_new), 0.0)
            alpha = torch.where(safe, torch.exp(m - m_new), 0.0)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, None, k0:k1]
            m = m_new
        out[:, :, :, q0:q1] = acc / torch.where(l == 0.0, 1.0, l)
        lse[:, :, :, q0:q1] = torch.where(l > 0.0, m + torch.log(l), -math.inf)[..., 0]
    out = out.reshape(b, hq, s_len, d).to(q.dtype)
    return (out, lse.reshape(b * hq, s_len)) if return_lse else out


def _kv_range(q0: int, q1: int, s_len: int, causal: bool, window, block_kv: int):
    """Keys [lo, hi) of the kv blocks that query rows [q0, q1) may see: the
    causal upper bound and the window's lower bound, on block edges."""
    lo = 0 if window is None else max(0, q0 - window + 1) // block_kv * block_kv
    hi = q1 if causal else s_len
    return lo, hi


def flash_attention_backward_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    sm_scale: float | None = None,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    block_q: int = 128,
    block_kv: int = 128,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) in the
    inputs' dtypes, computed in f32.

    ``lse`` is the forward's [B * Hq, S] log-sum-exp and ``do`` the
    output's gradient. Blocked as :func:`flash_attention_torch` (the same
    kv ranges per query block): per block, the probabilities are recomputed
    as ``P = exp(s - lse)`` (0 where masked or the row's lse is -inf) and
    ``dP = dO V^T``; a first sweep sums each row's ``D = sum_j P dP``, a
    second takes ``dV += P^T dO``, ``dS = P (dP - D)``, times ``1 - (s /
    cap)^2`` for a softcap, and ``dQ += dS K scale``, ``dK += dS^T Q
    scale``, summed over the GQA group.
    """
    b, hq, s_len, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    grouped = (b, hkv, group, s_len, d)
    qf = q.float().reshape(grouped)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(grouped)
    lse = lse.float().reshape(b, hkv, group, s_len, 1)
    live = torch.isfinite(lse)
    lse = torch.where(live, lse, 0.0)
    pos = torch.arange(s_len, device=q.device)

    def tiles(q0, q1):
        """(k0, k1, s, p, dp) of each kv block that query rows [q0, q1) see."""
        lo, hi = _kv_range(q0, q1, s_len, causal, window, block_kv)
        qb, dob = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
        for k0 in range(lo, hi, block_kv):
            k1 = min(k0 + block_kv, s_len)
            s = qb @ kf[:, :, None, k0:k1].transpose(-1, -2) * sm_scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            qp, kp = pos[q0:q1, None], pos[None, k0:k1]
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kp <= qp
            if window is not None:
                mask &= qp - kp < window
            mask = mask & live[:, :, :, q0:q1]
            p = torch.where(mask, torch.exp(s - lse[:, :, :, q0:q1]), 0.0)
            yield k0, k1, s, p, dob @ vf[:, :, None, k0:k1].transpose(-1, -2)

    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, s_len, block_q):
        q1 = min(q0 + block_q, s_len)
        qb, dob = qf[:, :, :, q0:q1], dof[:, :, :, q0:q1]
        delta = sum((p * dp).sum(dim=-1, keepdim=True) for _, _, _, p, dp in tiles(q0, q1))
        for k0, k1, s, p, dp in tiles(q0, q1):
            ds = p * (dp - delta)
            if softcap is not None:
                ds = ds * (1.0 - (s / softcap) ** 2)
            dv[:, :, k0:k1] += (p.transpose(-1, -2) @ dob).sum(dim=2)
            dk[:, :, k0:k1] += (ds.transpose(-1, -2) @ qb).sum(dim=2)
            dq[:, :, :, q0:q1] += ds @ kf[:, :, None, k0:k1]
    return ((dq * sm_scale).reshape(b, hq, s_len, d).to(q.dtype),
            (dk * sm_scale).to(k.dtype), dv.to(v.dtype))


def flash_attention_padded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Causal :func:`flash_attention` (default blocks, 128) for any S.

    An S above 128 that is not a multiple of it is padded at the end to the
    next multiple, and the padded query rows are dropped. This is exact
    under the causal mask: every padded key comes after every real query.
    (An S up to 128 is one block already.)
    """
    s_len = q.shape[2]
    pad = (-s_len) % 128 if s_len > 128 else 0
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    out = flash_attention(q, k, v, sm_scale=sm_scale, causal=True,
                          window=window, softcap=softcap)
    return out[:, :, :s_len] if pad else out
