"""The port's flash attention against the JAX package's, on the CPU.

The port's plain version (``flash_attention_torch``, which the wrapper runs
on CPU tensors) and its direct-softmax oracle (``reference_attention``) are
held against the JAX ``reference_attention`` on the whole sweep of
tests/test_kernels_flash.py, with the same inputs (made from the same numpy
seed) and the same tolerances: 2e-5 in f32, 2e-2 in bf16. Three small cases
also hold it against the Pallas kernel in interpret mode. The CUDA kernels
themselves run only on a GPU (tests/test_torch_cuda.py, chip_smoke.py); the
numerical design of the tensor-core kernel, which rounds the probabilities
to 16 bits before P V, is held against the JAX reference here through a
test-local copy of its algorithm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro.kernels.ref import reference_attention as _jax_reference_attention
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    NEG_INF, flash_attention, flash_attention_padded, flash_attention_torch,
)
from repro_torch.kernels.ref import reference_attention

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These cases are small: one intra-op thread runs them as fast, and
    leaves the cores to the tests that other workers run beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# one XLA program per case, not one dispatch per op
jreference_attention = jax.jit(
    _jax_reference_attention, static_argnames=("causal", "window", "softcap"))

# (b, hq, hkv, s, d, options) of every case of tests/test_kernels_flash.py
SWEEP = (
    [((2, 4, 2, s, d), {}) for s in (128, 256, 512) for d in (64, 128)]
    + [((1, hq, hkv, 256, 64), {}) for hq, hkv in ((4, 4), (8, 2), (8, 1))]
    + [((1, 2, 2, 256, 64), {"window": w}) for w in (64, 128, 1000)]
    + [((1, 2, 1, 256, 64), {"cap": c}) for c in (20.0, 50.0)]
    + [((1, 2, 2, 128, 64), {"causal": False})]
    + [((2, 8, 4, 512, 128), {"window": 128, "cap": 50.0})]
    + [((1, 4, 2, 256, 64), {"dtype": jnp.bfloat16})]
)


def _ids(case):
    shape, opts = case
    return "x".join(map(str, shape)) + "".join(
        f"-{k}{getattr(v, '__name__', v)}" for k, v in opts.items())


def _inputs(b, hq, hkv, s, d, dtype=jnp.float32):
    """The JAX test's inputs, as JAX arrays and as torch tensors."""
    rng = np.random.default_rng(hash((b, hq, hkv, s, d)) % 2**31)
    j = [jnp.asarray(rng.standard_normal(shape), dtype)
         for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]
    return j, [_torch(x) for x in j]


def _torch(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", SWEEP, ids=_ids)
def test_plain_version_and_oracle_match_the_jax_reference(case):
    (b, hq, hkv, s, d), opts = case
    dtype = opts.get("dtype", jnp.float32)
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    kw = dict(causal=opts.get("causal", True), window=opts.get("window"),
              softcap=opts.get("cap"))
    (jq, jk, jv), (q, k, v) = _inputs(b, hq, hkv, s, d, dtype)
    want = jreference_attention(jq, jk, jv, **kw)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)           # CPU tensors: the plain version
    assert flash_attention.launches == before
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, tol)
    _close(flash_attention_torch(q, k, v, **kw), want, tol)
    _close(reference_attention(q, k, v, **kw), want, tol)


@pytest.mark.parametrize("case", [
    ((1, 2, 2, 128, 64), {"causal": False}),
    ((1, 2, 1, 256, 64), {"window": 64, "cap": 20.0}),
    ((1, 4, 2, 256, 64), {"dtype": jnp.bfloat16}),
], ids=_ids)
def test_plain_version_matches_the_pallas_kernel_in_interpret_mode(case):
    (b, hq, hkv, s, d), opts = case
    dtype = opts.get("dtype", jnp.float32)
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    kw = dict(causal=opts.get("causal", True), window=opts.get("window"),
              softcap=opts.get("cap"))
    (jq, jk, jv), (q, k, v) = _inputs(b, hq, hkv, s, d, dtype)
    want = jflash_attention(jq, jk, jv, interpret=True, **kw)
    _close(flash_attention(q, k, v, **kw), want, tol)


@pytest.mark.parametrize("s,opts", [(200, {}), (300, {"window": 64, "softcap": 30.0}),
                                    (96, {"window": 16})])
def test_ragged_length_through_the_padding_path(s, opts):
    (jq, jk, jv), (q, k, v) = _inputs(1, 4, 2, s, 64)
    want = jreference_attention(jq, jk, jv, causal=True, **opts)
    got = flash_attention_padded(q, k, v, **opts)
    assert got.shape == q.shape
    _close(got, want, 2e-5)
    # the plain version takes short last blocks itself
    _close(flash_attention_torch(q, k, v, **opts), want, 2e-5)


def test_fully_masked_rows_give_zero():
    _, (q, k, v) = _inputs(1, 2, 2, 128, 64)
    for fn in (flash_attention, flash_attention_torch, reference_attention):
        out = fn(q, k, v, window=0)               # q - k < 0 never holds causally
        assert torch.equal(out, torch.zeros_like(out))


def test_wrapper_keeps_the_reference_validation():
    _, (q, k, v) = _inputs(1, 4, 2, 256, 64)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        flash_attention(q, k[:, :1].expand(1, 3, 256, 64), v[:, :1].expand(1, 3, 256, 64))
    _, (q, k, v) = _inputs(1, 4, 2, 200, 64)
    with pytest.raises(ValueError, match="not divisible by blocks"):
        flash_attention(q, k, v)                  # 200 % min(128, 200) != 0
    with pytest.raises(ValueError, match="not divisible by blocks"):
        flash_attention(q, k, v, block_kv=64)
    assert flash_attention(q, k, v, block_q=200, block_kv=200).shape == q.shape
    # meta tensors (the dry-run's) take the same validation, then the meta
    # path: an empty output of q's shape and dtype
    with pytest.raises(ValueError, match="not divisible by blocks"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    out = flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), block_q=200,
                          block_kv=200)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype


def test_kernel_request_raises_without_the_toolkit():
    if torch.cuda.is_available() or _build.shutil.which("nvcc"):
        pytest.skip("a GPU or nvcc is present; this checks the machine without")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.load("flash_attention")


# ------------------------------------------------ the tensor-core design

def _tensor_core_algorithm(q, k, v, *, causal=True, window=None, softcap=None):
    """The tensor-core kernel's arithmetic in plain torch: 128-row query
    blocks, kv tiles of 128 keys (64 for D >= 192), f32 scores and running
    statistics, the row sum over f32 probabilities, and P rounded to the
    input's 16-bit type before P V (the one departure from the reference,
    which keeps P in f32). Products of 16-bit values are exact in f32, so
    the two products are f32 matmuls of the rounded operands."""
    b, hq, s_len, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    bkv = 128 if d <= 128 else 64
    scale = d ** -0.5
    qf = q.float().reshape(b, hkv, group, s_len, d)
    kf, vf = k.float(), v.float()
    pos = torch.arange(s_len)
    out = torch.empty_like(qf)
    for q0 in range(0, s_len, 128):
        q1 = min(q0 + 128, s_len)
        m = torch.full((b, hkv, group, q1 - q0, 1), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, group, q1 - q0, d))
        for k0 in range(0, s_len, bkv):
            k1 = min(k0 + bkv, s_len)
            s = qf[:, :, :, q0:q1] @ kf[:, :, None, k0:k1].transpose(-1, -2) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            qp, kp = pos[q0:q1, None], pos[None, k0:k1]
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool)
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
            acc = acc * alpha + p.to(q.dtype).float() @ vf[:, :, None, k0:k1]
            m = m_new
        out[:, :, :, q0:q1] = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, hq, s_len, d).to(q.dtype)


# the sweep's shapes in bf16 and f16, the gemma2 combination at D 256 and a
# D 192 case: every head dim the tensor-core kernel takes
TENSOR_CORE_CASES = (
    [(shape, dict(opts, dtype=dt)) for shape, opts in SWEEP if "dtype" not in opts
     for dt in (jnp.bfloat16, jnp.float16)]
    + [((2, 8, 4, 512, 256), {"window": 128, "cap": 50.0, "dtype": jnp.bfloat16}),
       ((1, 4, 2, 256, 192), {"dtype": jnp.float16}),
       ((1, 4, 2, 256, 192), {"window": 100, "dtype": jnp.bfloat16})]
)


@pytest.mark.parametrize("case", TENSOR_CORE_CASES, ids=_ids)
def test_tensor_core_rounding_of_p_stays_within_the_16_bit_tolerance(case):
    (b, hq, hkv, s, d), opts = case
    kw = dict(causal=opts.get("causal", True), window=opts.get("window"),
              softcap=opts.get("cap"))
    (jq, jk, jv), (q, k, v) = _inputs(b, hq, hkv, s, d, opts["dtype"])
    want = jreference_attention(jq, jk, jv, **kw)
    got = _tensor_core_algorithm(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, 2e-2)
