"""The port's flash-attention gradient against JAX's autodiff, on the CPU.

The JAX package trains through ``jax.value_and_grad`` of its attention; its
Pallas kernel has no VJP. The port's backward kernel computes the same
gradient, and its plain version (``flash_attention_backward_torch``), which
the autograd Function runs on CPU tensors, is held here against
``jax.vjp`` of the JAX ``reference_attention`` on the whole sweep of
tests/test_kernels_flash.py, with the same inputs (made from numpy seeds)
and the forward's tolerances: 2e-5 in f32, 2e-2 in bf16. The CUDA kernel
itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py); the rounding its tensor-core
variant adds is sized here by a copy of its algorithm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import reference_attention as _jax_reference_attention
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels.flash_attention import (
    _FlashAttention, flash_attention, flash_attention_backward,
    flash_attention_backward_torch, flash_attention_lse, flash_attention_padded,
    flash_attention_torch,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These cases are small: one intra-op thread runs them as fast, and
    leaves the cores to the tests that other workers run beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_grads(q, k, v, do, **kw):
    """(out, dq, dk, dv) of the JAX reference attention at cotangent do."""
    out, vjp = jax.vjp(lambda a, b, c: _jax_reference_attention(a, b, c, **kw), q, k, v)
    return (out, *vjp(do))


# one XLA program per case, not one dispatch per op
jax_grads = jax.jit(_jax_grads, static_argnames=("causal", "window", "softcap"))

# (b, hq, hkv, s, d, options) of every case of tests/test_kernels_flash.py,
# then window 0 (every row masked)
SWEEP = (
    [((2, 4, 2, s, d), {}) for s in (128, 256, 512) for d in (64, 128)]
    + [((1, hq, hkv, 256, 64), {}) for hq, hkv in ((4, 4), (8, 2), (8, 1))]
    + [((1, 2, 2, 256, 64), {"window": w}) for w in (64, 128, 1000)]
    + [((1, 2, 1, 256, 64), {"cap": c}) for c in (20.0, 50.0)]
    + [((1, 2, 2, 128, 64), {"causal": False})]
    + [((2, 8, 4, 512, 128), {"window": 128, "cap": 50.0})]
    + [((1, 4, 2, 256, 64), {"dtype": jnp.bfloat16})]
    + [((1, 2, 2, 128, 64), {"window": 0})]
)


def _ids(case):
    shape, opts = case
    return "x".join(map(str, shape)) + "".join(
        f"-{k}{getattr(v, '__name__', v)}" for k, v in opts.items())


def _inputs(b, hq, hkv, s, d, dtype=jnp.float32):
    """q, k, v and an output cotangent, as JAX arrays and torch tensors."""
    rng = np.random.default_rng(hash((b, hq, hkv, s, d)) % 2**31)
    j = [jnp.asarray(rng.standard_normal(shape), dtype)
         for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d))]
    return j, [_torch(x) for x in j]


def _torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _kw(opts):
    return dict(causal=opts.get("causal", True), window=opts.get("window"),
                softcap=opts.get("cap"))


@pytest.mark.parametrize("case", SWEEP, ids=_ids)
def test_gradient_matches_jax_autodiff_of_the_reference(case):
    """The plain backward (fed the plain forward's output and lse), and the
    autograd Function's CPU gradient, against jax.vjp of the reference."""
    (b, hq, hkv, s, d), opts = case
    dtype = opts.get("dtype", jnp.float32)
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    kw = _kw(opts)
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(b, hq, hkv, s, d, dtype)
    want = jax_grads(jq, jk, jv, jdo, **kw)

    o, lse = flash_attention_torch(q, k, v, return_lse=True, **kw)
    _close(o, want[0], tol)
    assert lse.shape == (b * hq, s) and lse.dtype == torch.float32
    got = flash_attention_backward_torch(q, k, v, lse, do, **kw)
    for g, w, t in zip(got, want[1:], (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, tol)

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention.backward_launches
    out = flash_attention(*leaves, **kw)
    assert type(out.grad_fn) is _FlashAttention._backward_cls
    grads = torch.autograd.grad(out, leaves, do)
    assert flash_attention.backward_launches == before    # CPU: no kernel
    for g, w in zip(grads, want[1:]):
        _close(g, w, tol)
    if kw["window"] == 0:                 # q - k < 0 never holds causally
        assert torch.isinf(lse).all() and (lse < 0).all()
        assert all(torch.equal(g, torch.zeros_like(g)) for g in grads)


@pytest.mark.parametrize("s,opts", [(200, {}), (300, {"window": 64, "softcap": 30.0})])
def test_gradient_through_the_padding_path(s, opts):
    """flash_attention_padded differentiates through its pad and slice."""
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(1, 4, 2, s, 64)
    want = jax_grads(jq, jk, jv, jdo, causal=True, **opts)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_padded(*leaves, **opts)
    assert out.shape == q.shape
    for g, w in zip(torch.autograd.grad(out, leaves, do), want[1:]):
        _close(g, w, 2e-5)


def test_output_carries_the_function_node_whenever_an_input_requires_grad():
    """The repair of a detached output: with grad on and any of q, k, v
    requiring grad, the result is the Function's; otherwise it is a plain
    tensor with no graph, as serving wants it."""
    _, (q, k, v, _) = _inputs(1, 4, 2, 128, 64)
    for i in range(3):
        qkv = [q, k, v]
        qkv[i] = qkv[i].clone().requires_grad_()
        out = flash_attention(*qkv)
        assert type(out.grad_fn) is _FlashAttention._backward_cls
        (g,) = torch.autograd.grad(out.sum(), qkv[i])
        assert g.abs().sum() > 0
    assert flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert flash_attention(q.clone().requires_grad_(), k, v).grad_fn is None
    # the Function's forward is the plain forward, bit for bit
    out = flash_attention(q.clone().requires_grad_(), k, v)
    assert torch.equal(out.detach(), flash_attention_torch(q, k, v))


def test_function_saves_the_forward_lse_and_calls_both_halves(monkeypatch):
    """The Function runs flash_attention_lse in its forward and
    flash_attention_backward in its backward, with the same options."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, kw["sm_scale"], kw["window"], kw["softcap"]))
            return fn(*args, **kw)
        monkeypatch.setattr(flash_mod, name, wrapped)

    spy("flash_attention_lse", flash_attention_lse)
    spy("flash_attention_backward", flash_attention_backward)
    _, (q, k, v, do) = _inputs(1, 2, 1, 256, 64)
    q.requires_grad_()
    out = flash_attention(q, k, v, sm_scale=0.1, window=64, softcap=20.0)
    torch.autograd.grad(out, q, do)
    assert calls == [("flash_attention_lse", 0.1, 64, 20.0),
                     ("flash_attention_backward", 0.1, 64, 20.0)]


def _shared_mean_inputs(ratio: float, d: int = 64):
    """bf16 q, k, v, d out whose queries and keys share a mean ``ratio``
    times their spread per head, as a deep decoder layer's do, with a
    softmax that is neither flat nor one-hot."""
    rng = np.random.default_rng(12)
    b, hq, hkv, s = 1, 4, 2, 256

    def shared(h):
        return 0.25 * (ratio * rng.standard_normal((b, h, 1, d))
                       + rng.standard_normal((b, h, s, d)))

    arrays = (shared(hq), shared(hkv), rng.standard_normal((b, hkv, s, d)),
              rng.standard_normal((b, hq, s, d)))
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    return j, [_torch(x) for x in j]


def _dense_dq(q, k, v, do, delta, dtype=None):
    """dq of causal attention (scale D^-0.5) with each row's D given (and,
    with ``dtype``, dS rounded to it before dq = dS K), densely in f32."""
    group = q.shape[1] // k.shape[1]
    scale = q.shape[-1] ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    c = qf @ kf.transpose(-1, -2) * scale
    ok = torch.ones(c.shape[-2:], dtype=torch.bool).tril()
    p = torch.softmax(torch.where(ok, c, -torch.inf), dim=-1)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    if dtype is not None:
        ds = ds.to(dtype).float()
    return ds @ kf * scale


# (shared mean over spread, softcap, D): whisper-small's D 64 cases, then
# gemma2's softcap 50 and head dims 128 (gemma2-27b) and 256 (gemma2-9b)
SHARED_MEAN_CASES = (
    [pytest.param(r, None, 64, id=f"{r}") for r in (12.0, 32.0)]
    + [pytest.param(r, cap, d, id=f"{r}-{'softcap50' if cap else 'nocap'}-D{d}")
       for r in (16.0, 32.0) for cap in (None, 50.0) for d in (128, 256)]
)


@pytest.mark.parametrize("ratio,cap,d", SHARED_MEAN_CASES)
def test_gradient_holds_when_the_keys_share_a_mean(ratio, cap, d):
    """A component that every key shares reaches dq times any error in
    sum_j dS_ij; without a softcap that sum is 0, so the exact dq lacks the
    component. At a shared mean 12, 16 and 32 times the spread
    (whisper-small's last decoder layer: ~13): without a softcap, D taken
    as dO . o from the 16-bit output, as FlashAttention-2 does, and dS
    rounded to 16 bits with no epilogue correction each leave the bf16
    gate (2e-2 of max |g|) of JAX's autodiff at 32; with softcap 50 the
    tensor-core dq as it was before its repair (the rounded dS's row sums
    taken out only without a softcap, so nothing with one) leaves it at 32.
    The plain backward (D from P dP), the Function and the repaired
    tensor-core algorithm (each row's sum of dS's rounding errors times k_i
    taken out, with a softcap as without) stay within 1e-2 in every case."""
    (jq, jk, jv, jdo), (q, k, v, do) = _shared_mean_inputs(ratio, d)
    kw = dict(sm_scale=d ** -0.5, softcap=cap)
    want = [torch.from_numpy(np.asarray(w, np.float32))
            for w in jax_grads(jq, jk, jv, jdo, causal=True, window=None, softcap=cap)[1:]]
    err = lambda g, w: float((g.float() - w).abs().max() / w.abs().max())  # noqa: E731
    out, lse = flash_attention_lse(q, k, v, **kw)
    if ratio > 16 and cap is None:
        d_rounded = (do.float() * out.float()).sum(-1, keepdim=True)
        d_exact = (do.float() * flash_attention_torch(q.float(), k.float(), v.float(), **kw)
                   ).sum(-1, keepdim=True)
        assert err(_dense_dq(q, k, v, do, d_rounded), want[0]) > 2e-2
        assert err(_dense_dq(q, k, v, do, d_exact, torch.bfloat16), want[0]) > 2e-2
    if ratio > 16 and cap is not None:
        before = _rounded_grads(q, k, v, do, dtype=torch.bfloat16, softcap=cap, repaired=False)
        assert err(before[0], want[0]) > 2e-2
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    by_function = torch.autograd.grad(flash_attention(*leaves, **kw), leaves, do)
    plain = flash_attention_backward_torch(q, k, v, lse, do, **kw)
    tensor_core = _rounded_grads(q, k, v, do, dtype=torch.bfloat16, softcap=cap)
    for grads in (by_function, plain, tensor_core):
        for g, w in zip(grads, want):
            assert err(g, w) <= 1e-2


def test_lse_is_the_row_log_sum_exp():
    """lse = log sum_j exp(s_ij) over the unmasked scores of each row."""
    _, (q, k, v, _) = _inputs(1, 4, 2, 128, 64)
    _, lse = flash_attention_lse(q, k, v, sm_scale=0.125, window=32, softcap=20.0)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, dim=1)) * 0.125
    s = 20.0 * torch.tanh(s / 20.0)
    pos = torch.arange(128)
    ok = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < 32)
    want = torch.logsumexp(torch.where(ok, s, -torch.inf), dim=-1).reshape(4, 128)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)


def _rounded_grads(q, k, v, do, *, dtype, causal=True, window=None, softcap=None,
                   repaired=True):
    """dq, dk, dv (f32) as the tensor-core backward kernels compute them: f32
    scores, P = exp(c - lse) from the forward's f32 lse, D = rowsum(P dP),
    and P and dS rounded to ``dtype`` before the products that take them
    (dV = P^T dO, dK = dS^T Q, dQ = dS K; at D 256 P^T and dS^T pass
    through shared memory in ``dtype``, the same rounding), then dq_i less
    the row's sum of dS's rounding errors times k_i; every sum in f32.
    ``repaired=False`` is the epilogue as it was before: the rounded dS's
    row sum times k_i taken out without a softcap, nothing with one."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    scale = d ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    c = qf @ kf.transpose(-1, -2) * scale
    if softcap is not None:
        c = softcap * torch.tanh(c / softcap)
    pos = torch.arange(s)
    ok = torch.ones((s, s), dtype=torch.bool)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window is not None:
        ok &= pos[:, None] - pos[None, :] < window
    lse = torch.logsumexp(torch.where(ok, c, -torch.inf), dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(c - lse), 0.0)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if softcap is not None:
        ds = ds * (1.0 - (c / softcap) ** 2)
    p16, ds16 = p.to(dtype).float(), ds.to(dtype).float()
    dq = ds16 @ kf
    if repaired:
        dq = dq - (ds16 - ds).sum(-1, keepdim=True) * kf
    elif softcap is None:
        dq = dq - ds16.sum(-1, keepdim=True) * kf

    def group_sum(x):
        return x.reshape(b, hq // group, group, s, d).sum(dim=2)

    return (dq * scale, group_sum(ds16.transpose(-1, -2) @ qf) * scale,
            group_sum(p16.transpose(-1, -2) @ dof))


def _jax_value_and_grads(q, k, v, do, **kw):
    """jax.value_and_grad of sum(reference_attention(q, k, v) * do)."""
    def loss(a, b, c):
        out = _jax_reference_attention(a, b, c, **kw)
        return jnp.sum(out.astype(jnp.float32) * do.astype(jnp.float32))

    return jax.value_and_grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("opts", [{}, {"window": 64, "softcap": 30.0}, {"d": 256},
                                  {"d": 256, "window": 64, "softcap": 50.0}],
                         ids=["causal", "window-softcap", "D256", "D256-gemma2"])
def test_tensor_core_backward_rounding_stays_inside_the_gate(dtype, opts):
    """The tensor-core backward rounds P and dS to 16 bits before their
    products, where the plain version keeps f32 (at D 256 P^T and dS^T go
    through shared memory in 16 bits). At a reduced training shape (S 256,
    D 128, GQA 2, causal) and at D 256 with gemma2's softcap 50 (and a
    window of 64, which bites at S 256 as gemma2's 4096 does in training)
    that rounding keeps each gradient within the 16-bit gate, 2e-2 of its
    max |g|, of JAX's autodiff."""
    opts = dict(opts)
    d = opts.pop("d", 128)
    jdtype = getattr(jnp, dtype)
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(1, 4, 2, 256, d, jdtype)
    assert q.dtype == getattr(torch, dtype)
    _, want = _jax_value_and_grads(jq, jk, jv, jdo, causal=True, **opts)
    got = _rounded_grads(q, k, v, do, dtype=getattr(torch, dtype), **opts)
    for g, w in zip(got, want):
        w = torch.from_numpy(np.asarray(w, np.float32))
        assert g.shape == w.shape
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= 2e-2, err
