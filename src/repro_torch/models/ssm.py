"""Recurrent sequence mixers: mLSTM (xLSTM), sLSTM (xLSTM), Mamba2-style SSD.

The PyTorch counterpart of the JAX package's ``src/repro/models/ssm.py``.
One generic *chunked linear recurrence* drives both mLSTM and SSD:

    state_t = a_t * state_{t-1} + k_t ⊗ v_t          (state: [dk, dv])
    y_t     = q_t @ state_t

computed chunk-parallel: intra-chunk masked matmuls with cumulative decay,
and a Python loop over the chunks (the reference's ``lax.scan``) carrying
the state, all in f32.

mLSTM's exponential input gate is in its normalised form, as in the
reference: the normaliser n_t rides as a ones column appended to v, and the
gates are sigmoid / log-sigmoid with per-step decay in log space, all decays
<= 1. sLSTM keeps the published stabilised recurrence (m_t running max) and
is a sequential loop over time. Every mixer has a decode step with O(1)
state.

The reference has no Pallas kernel for these recurrences; they are plain
torch ops here, as they are plain ``jnp`` there. Parameters are dicts of
tensors with the reference's keys; the ``*_init`` functions draw from an
explicit ``torch.Generator`` on an explicit device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import dense_param, rms_norm


# ------------------------------------------------- generic chunked recurrence

def chunked_linear_recurrence(
    q: torch.Tensor,        # [B, H, T, dk]
    k: torch.Tensor,        # [B, H, T, dk]
    v: torch.Tensor,        # [B, H, T, dv]
    log_a: torch.Tensor,    # [B, H, T] per-step log decay (<= 0)
    *,
    chunk: int = 128,
    init_state: torch.Tensor | None = None,   # [B, H, dk, dv]
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [B, H, T, dv], final state [B, H, dk, dv]), both f32.

    The decays inside a chunk are ``exp(L_i - L_j)`` for ``j <= i``; the
    reference takes ``exp`` of every pair and zeroes the ``j > i`` ones
    after, where ``L_i - L_j`` is positive and overflows to inf once a
    chunk's decay passes ~88 nats (at full width, about 110 steps of a
    random gate). The forward is the same either way, but the gradient of
    the overflowed entries is 0 * inf = NaN. Here the ``j > i`` entries
    are set to -inf before the ``exp``: the same values, and a gradient
    that is the reference's wherever the reference's is finite."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, t)
    t_pad = (-t) % c
    if t_pad:
        # zero-pad to a chunk multiple: k=v=0 contributes nothing and
        # log_a=0 leaves the carried state unchanged, so semantics hold
        q, k, v = (F.pad(x, (0, 0, 0, t_pad)) for x in (q, k, v))
        log_a = F.pad(log_a, (0, t_pad))
    nc = (t + t_pad) // c
    f32 = torch.float32
    qc = q.reshape(b, h, nc, c, dk).to(f32)
    kc = k.reshape(b, h, nc, c, dk).to(f32)
    vc = v.reshape(b, h, nc, c, dv).to(f32)
    cum = torch.cumsum(log_a.reshape(b, h, nc, c).to(f32), dim=-1)   # L_i

    # one chunk per step: the [c, c] decay/score tensors exist for a single
    # chunk at a time, never [nc, c, c] for the whole sequence
    state = (init_state.to(f32) if init_state is not None
             else torch.zeros((b, h, dk, dv), dtype=f32, device=q.device))
    future = ~torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    ys = []
    for n in range(nc):
        q_n, k_n, v_n, cum_n = qc[:, :, n], kc[:, :, n], vc[:, :, n], cum[:, :, n]
        # intra-chunk: y[i] = sum_{j<=i} exp(L_i - L_j) (q_i.k_j) v_j
        diff = cum_n[..., :, None] - cum_n[..., None, :]
        decay = torch.exp(diff.masked_fill(future, -torch.inf))
        s = torch.einsum("bhid,bhjd->bhij", q_n, k_n) * decay
        y_n = torch.einsum("bhij,bhjv->bhiv", s, v_n)
        # cross-chunk: y[i] += exp(L_i) * q_i @ state
        y_n = y_n + torch.einsum(
            "bhid,bhdv->bhiv", q_n * torch.exp(cum_n)[..., None], state)
        # carry: state = exp(L_last) * state + sum_j exp(L_last - L_j) k_j v_j
        w = torch.exp(cum_n[..., -1:] - cum_n)
        summary = torch.einsum("bhjd,bhj,bhjv->bhdv", k_n, w, v_n)
        state = state * torch.exp(cum_n[..., -1])[..., None, None] + summary
        ys.append(y_n)
    y = torch.cat(ys, dim=2)[:, :, :t]
    return y, state


def linear_recurrence_step(
    q: torch.Tensor,      # [B, H, dk]
    k: torch.Tensor,
    v: torch.Tensor,      # [B, H, dv]
    log_a: torch.Tensor,  # [B, H]
    state: torch.Tensor,  # [B, H, dk, dv]
) -> tuple[torch.Tensor, torch.Tensor]:
    a = torch.exp(log_a.float())[..., None, None]
    state = state * a + k.float()[..., :, None] * v.float()[..., None, :]
    y = torch.einsum("bhd,bhdv->bhv", q.float(), state)
    return y, state


# ----------------------------------------------------------------- mLSTM

class MLSTMState(NamedTuple):
    c: torch.Tensor   # [B, H, dk, dv+1] (last column = normaliser n)


def mlstm_init(gen: torch.Generator, d_model: int, num_heads: int, dtype,
               device) -> dict:
    return {
        "w_q": dense_param(gen, d_model, d_model, dtype, device),
        "w_k": dense_param(gen, d_model, d_model, dtype, device),
        "w_v": dense_param(gen, d_model, d_model, dtype, device),
        "w_if": dense_param(gen, d_model, 2 * num_heads, dtype, device),  # i,f gates
        "w_o": dense_param(gen, d_model, d_model, dtype, device),
        "out_norm": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def _mlstm_qkv(params, x, num_heads):
    b, t, d = x.shape
    dh = d // num_heads

    def heads(y):
        return y.reshape(b, t, num_heads, dh).transpose(1, 2)

    q = heads(x @ params["w_q"]) * dh**-0.5
    k = heads(x @ params["w_k"]) * dh**-0.5
    v = heads(x @ params["w_v"])
    gates = (x @ params["w_if"]).reshape(b, t, num_heads, 2).transpose(1, 2)
    i_gate = torch.sigmoid(gates[..., 0].float())
    log_f = F.logsigmoid(gates[..., 1].float())
    return q, k, v, i_gate, log_f


def _with_ones(v: torch.Tensor) -> torch.Tensor:
    """v with the normaliser's ones column appended."""
    return torch.cat([v, torch.ones((*v.shape[:-1], 1), dtype=v.dtype,
                                    device=v.device)], dim=-1)


def _mlstm_out(params, y, x_dtype, b, t, d):
    num = y[..., :-1]
    den = y[..., -1:]
    h = num / torch.clamp(den.abs(), min=1.0)
    h = h.transpose(1, 2).reshape(b, t, d).to(x_dtype)
    return rms_norm(h, params["out_norm"]) @ params["w_o"]


def mlstm(params: dict, x: torch.Tensor, num_heads: int, *, chunk: int = 128):
    """Parallel (training/prefill) mLSTM; returns output + final state."""
    b, t, d = x.shape
    q, k, v, i_gate, log_f = _mlstm_qkv(params, x, num_heads)
    y, state = chunked_linear_recurrence(
        q, k * i_gate[..., None].to(k.dtype), _with_ones(v), log_f, chunk=chunk)
    return _mlstm_out(params, y, x.dtype, b, t, d), MLSTMState(state)


def mlstm_step(params: dict, x: torch.Tensor, state: MLSTMState, num_heads: int):
    """O(1) decode step; x: [B, 1, d]."""
    b, t, d = x.shape
    q, k, v, i_gate, log_f = _mlstm_qkv(params, x, num_heads)
    y, new = linear_recurrence_step(
        q[:, :, 0], (k * i_gate[..., None].to(k.dtype))[:, :, 0],
        _with_ones(v)[:, :, 0], log_f[:, :, 0], state.c,
    )
    return _mlstm_out(params, y[:, :, None, :], x.dtype, b, 1, d), MLSTMState(new)


# ----------------------------------------------------------------- sLSTM

class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, H, dh]
    n: torch.Tensor   # [B, H, dh]
    m: torch.Tensor   # [B, H, dh]
    h: torch.Tensor   # [B, H, dh]


def slstm_init(gen: torch.Generator, d_model: int, num_heads: int, dtype,
               device) -> dict:
    dh = d_model // num_heads
    r_h = torch.randn((num_heads, dh, 4 * dh), generator=gen, device=device,
                      dtype=torch.float32)
    return {
        # 4 gates (i, f, z, o) from input and block-diagonal recurrence
        "w_x": dense_param(gen, d_model, 4 * d_model, dtype, device),
        "r_h": (r_h / dh**0.5).to(dtype),
        "b": torch.zeros((4 * d_model,), dtype=dtype, device=device),
        "w_o": dense_param(gen, d_model, d_model, dtype, device),
        "out_norm": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def slstm_zero_state(batch: int, d_model: int, num_heads: int,
                     device="cuda") -> SLSTMState:
    dh = d_model // num_heads
    z = torch.zeros((batch, num_heads, dh), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z - 10.0, z)


def _slstm_cell(r_h: torch.Tensor, xg: torch.Tensor, state: SLSTMState,
                num_heads: int, dh: int) -> SLSTMState:
    """One stabilised sLSTM step. xg: [B, 4*d] pre-computed input gates;
    ``r_h`` the recurrence in f32."""
    b = xg.shape[0]
    rec = torch.einsum("bhd,hdg->bhg", state.h.float(), r_h)
    g = xg.reshape(b, num_heads, 4 * dh).float() + rec
    gi, gf, gz, go = torch.split(g, dh, dim=-1)
    m_new = torch.maximum(gf + state.m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(gf + state.m - m_new)
    c = f * state.c + i * torch.tanh(gz)
    n = f * state.n + i
    h = torch.sigmoid(go) * c / torch.clamp(n.abs(), min=1.0)
    return SLSTMState(c, n, m_new, h)


def slstm(params: dict, x: torch.Tensor, num_heads: int,
          state: SLSTMState | None = None):
    """Sequential sLSTM over time (a loop of one cell per step); returns
    output + final state."""
    b, t, d = x.shape
    dh = d // num_heads
    xg = (x @ params["w_x"] + params["b"]).float()              # [B,T,4d]
    if state is None:
        state = slstm_zero_state(b, d, num_heads, x.device)
    # the reference recasts r_h every step (XLA hoists it): cast it once
    r_h = params["r_h"].float()
    hs = []
    for i in range(t):
        state = _slstm_cell(r_h, xg[:, i], state, num_heads, dh)
        hs.append(state.h)
    h = torch.stack(hs, dim=1).reshape(b, t, d).to(x.dtype)
    return rms_norm(h, params["out_norm"]) @ params["w_o"], state


def slstm_step(params: dict, x: torch.Tensor, state: SLSTMState, num_heads: int):
    b, t, d = x.shape
    dh = d // num_heads
    xg = (x[:, 0] @ params["w_x"] + params["b"]).float()
    new = _slstm_cell(params["r_h"].float(), xg, state, num_heads, dh)
    h = new.h.reshape(b, 1, d).to(x.dtype)
    return rms_norm(h, params["out_norm"]) @ params["w_o"], new


# ------------------------------------------------------------------- SSD

class SSDState(NamedTuple):
    h: torch.Tensor   # [B, H, N, dh]


def ssd_init(gen: torch.Generator, d_model: int, num_heads: int, state_dim: int,
             dtype, device) -> dict:
    return {
        "w_x": dense_param(gen, d_model, d_model, dtype, device),
        "w_b": dense_param(gen, d_model, num_heads * state_dim, dtype, device),
        "w_c": dense_param(gen, d_model, num_heads * state_dim, dtype, device),
        "w_dt": dense_param(gen, d_model, num_heads, dtype, device),
        # A = -exp(a_log); both f32 whatever the model's dtype
        "a_log": torch.zeros((num_heads,), dtype=torch.float32, device=device),
        "d_skip": torch.ones((num_heads,), dtype=torch.float32, device=device),
        "w_o": dense_param(gen, d_model, d_model, dtype, device),
        "out_norm": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def _ssd_proj(params, x, num_heads, state_dim):
    b, t, d = x.shape
    dh = d // num_heads
    xs = (x @ params["w_x"]).reshape(b, t, num_heads, dh).transpose(1, 2)
    bb = (x @ params["w_b"]).reshape(b, t, num_heads, state_dim).transpose(1, 2)
    cc = (x @ params["w_c"]).reshape(b, t, num_heads, state_dim).transpose(1, 2)
    # torch's softplus returns x itself above 20, where JAX's is
    # logaddexp(x, 0): they differ there by log1p(exp(-x)) < 2.1e-9, below
    # half an f32 ulp of x (tests/test_torch_ssm.py holds the two)
    dt = F.softplus((x @ params["w_dt"]).float())               # [b,t,h]
    dt = dt.transpose(1, 2)                                     # [b,h,t]
    log_a = -torch.exp(params["a_log"])[None, :, None] * dt     # <= 0
    return xs, bb, cc, dt, log_a


def _ssd_out(params, y, xs, x_dtype, b, t, d):
    y = y + xs.float() * params["d_skip"][None, :, None, None]
    h = y.transpose(1, 2).reshape(b, t, d).to(x_dtype)
    return rms_norm(h, params["out_norm"]) @ params["w_o"]


def ssd(params: dict, x: torch.Tensor, num_heads: int, state_dim: int,
        *, chunk: int = 128):
    """Mamba2-style SSD (training/prefill); returns output + final state."""
    b, t, d = x.shape
    xs, bb, cc, dt, log_a = _ssd_proj(params, x, num_heads, state_dim)
    v = xs * dt.to(xs.dtype)[..., None]
    y, state = chunked_linear_recurrence(cc, bb, v, log_a, chunk=chunk)
    return _ssd_out(params, y, xs, x.dtype, b, t, d), SSDState(state)


def ssd_step(params: dict, x: torch.Tensor, state: SSDState, num_heads: int,
             state_dim: int):
    b, t, d = x.shape
    xs, bb, cc, dt, log_a = _ssd_proj(params, x, num_heads, state_dim)
    v = xs * dt.to(xs.dtype)[..., None]
    y, new = linear_recurrence_step(
        cc[:, :, 0], bb[:, :, 0], v[:, :, 0], log_a[:, :, 0], state.h)
    return _ssd_out(params, y[:, :, None, :], xs, x.dtype, b, 1, d), SSDState(new)
