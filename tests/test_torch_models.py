"""The port's dense LM serving path against the JAX package's, on the CPU
(the DeepSeek family's: tests/test_torch_moe.py).

Parameters are made by the JAX package's init and carried across with
``repro_torch.interop.lm_params_from_numpy``; inputs come from numpy seeds.
Everything runs in f32 (the ``reduced()`` configs), where the two packages
differ only by the order of f32 sums: logits agree within 1e-5 (they are
O(1), and a reduced model's differences measure ~1e-6), and greedy tokens
are equal. On the CPU the flash-attention wrapper runs its plain version;
the kernel itself is held against that version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.serve import serve_batch as jserve_batch
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import param_count as jparam_count
from repro.models.attention import KVCache as JKVCache
from repro.models.attention import _blocked_scores_attention as j_blocked
from repro.models.attention import gqa_attention as _jgqa_attention
from repro.models.attention import gqa_init as jgqa_init
from repro.models.attention import make_kv_cache as jmake_kv_cache
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve
from repro_torch.models import attention, build_model, layers, param_count

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These cases are small: one intra-op thread runs them as fast, and
    leaves the cores to the tests that other workers run beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# The JAX functions run jitted: one XLA program per call shape is much
# cheaper on the CPU than compiling each op on first use.
jgqa_attention = jax.jit(_jgqa_attention,
                         static_argnames=("cfg", "window", "prefix_len"))


def _t(x) -> torch.Tensor:
    """A JAX array (or numpy array) as a torch tensor on the CPU."""
    return lm_params_from_numpy({"x": np.asarray(x)}, device="cpu")["x"]


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ layers

def test_rms_norm_and_softcap_match():
    x, w = _rand(3, 5, 64), _rand(64, seed=1) * 0.1
    _close(layers.rms_norm(_t(x), _t(w)), jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    for cap in (None, 30.0):
        _close(layers.softcap(_t(x) * 40, cap), jlayers.softcap(jnp.asarray(x) * 40, cap))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    x = _rand(2, 4, 9, 32)
    pos = np.array([0, 1, 2, 3, 5, 8, 13, 21, 34])
    got = layers.rope(_t(x), torch.as_tensor(pos)[None, None, :], theta=theta)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos)[None, None, :], theta=theta)
    _close(got, want)


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "geglu"])
def test_mlps_match(kind):
    init = jlayers.gelu_mlp_init if kind == "gelu" else jlayers.swiglu_mlp_init
    jp = init(jax.random.PRNGKey(0), 64, 128, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = _rand(2, 7, 64)
    got = getattr(layers, f"{kind}_mlp")(p, _t(x))
    want = getattr(jlayers, f"{kind}_mlp")(jp, jnp.asarray(x))
    _close(got, want)


# --------------------------------------------------------------- attention

def _attn_case(name):
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    jp = jgqa_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, cfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("name,window", [("qwen3-0.6b", None), ("gemma2-9b", 16)])
def test_gqa_attention_prefill_and_decode_match(name, window):
    jcfg, cfg, jp, p = _attn_case(name)
    b, s, cache_len = 2, 40, 48
    x = _rand(b, s + 2, cfg.d_model, seed=3)
    jcache = jmake_kv_cache(jcfg, b, cache_len, jnp.float32)
    cache = attention.make_kv_cache(cfg, b, cache_len, torch.float32, "cpu")
    pos = np.arange(s)
    before = flash_attention.launches
    want, jcache = jgqa_attention(jp, jnp.asarray(x[:, :s]), jnp.asarray(pos), jcfg,
                                  window=window, cache=jcache)
    got, cache = attention.gqa_attention(p, _t(x[:, :s]), torch.as_tensor(pos), cfg,
                                         window=window, cache=cache)
    _close(got, want)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)
    for i in (s, s + 1):                                    # decode steps
        want, jcache = jgqa_attention(jp, jnp.asarray(x[:, i:i + 1]), jnp.asarray([i]),
                                      jcfg, window=window, cache=jcache)
        got, cache = attention.gqa_attention(p, _t(x[:, i:i + 1]), torch.tensor([i]),
                                             cfg, window=window, cache=cache)
        _close(got, want)
    assert flash_attention.launches == before              # CPU: no kernel


@pytest.mark.parametrize("offset", [2, 5])
def test_gqa_attention_prefill_at_an_offset_matches(offset):
    """A prefill of 4 tokens into a cache of 16 that already holds earlier
    entries: k/v written at the offset, attention over the whole cache (the
    earlier entries and the prompt; later slots masked), as the reference
    computes it."""
    jcfg, cfg, jp, p = _attn_case("qwen3-0.6b")
    b, s, cache_len = 2, 4, 16
    x = _rand(b, s, cfg.d_model, seed=12)
    old = _rand(2, b, cfg.num_kv_heads, cache_len, cfg.head_dim, seed=13)
    jcache = JKVCache(jnp.asarray(old[0]), jnp.asarray(old[1]))
    cache = attention.KVCache(_t(old[0]), _t(old[1]))
    pos = np.arange(offset, offset + s)
    want, jcache = jgqa_attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, cache=jcache)
    got, cache = attention.gqa_attention(p, _t(x), torch.as_tensor(pos), cfg, cache=cache)
    _close(got, want)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)


def test_gqa_attention_non_flash_passes_match():
    """Passes the kernel does not take: prefix-LM, cross-attention, and the
    blocked scores path (one query block at a time, ragged last block)."""
    jcfg, cfg, jp, p = _attn_case("gemma2-9b")
    x = _rand(2, 24, cfg.d_model, seed=4)
    pos = np.arange(24)
    want, _ = jgqa_attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, prefix_len=8)
    got, _ = attention.gqa_attention(p, _t(x), torch.as_tensor(pos), cfg, prefix_len=8)
    _close(got, want)
    kv = _rand(2, 2, 10, 32, seed=5), _rand(2, 2, 10, 32, seed=6)
    want, _ = jgqa_attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                             cross_kv=tuple(map(jnp.asarray, kv)))
    got, _ = attention.gqa_attention(p, _t(x), torch.as_tensor(pos), cfg,
                                     cross_kv=tuple(map(_t, kv)))
    _close(got, want)
    qg, k, v = _rand(1, 2, 2, 600, 32, seed=7), _rand(1, 2, 650, 32, seed=8), _rand(1, 2, 650, 32, seed=9)
    q_pos, k_pos = np.arange(50, 650), np.arange(650)
    valid = k_pos <= 640
    kw = dict(scale=0.2, attn_softcap=50.0, causal=True, window=64, prefix_len=None)
    want = j_blocked(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
                     jnp.asarray(k_pos), valid=jnp.asarray(valid), **kw)
    got = attention._blocked_scores_attention(
        _t(qg), _t(k), _t(v), torch.as_tensor(q_pos), torch.as_tensor(k_pos),
        valid=torch.as_tensor(valid), **kw)
    _close(got, want)


# ------------------------------------------------------------- end to end

def _model(name, dtype=jnp.float32):
    jcfg = dataclasses.replace(jget_config(name).reduced(), dtype=dtype)
    jspec = jbuild_model(jcfg)
    jspec = dataclasses.replace(jspec, prefill=jax.jit(jspec.prefill, static_argnums=2))
    jp = jax.jit(jspec.init)(jax.random.PRNGKey(0))
    spec = build_model(get_config(name).reduced())
    return jspec, jp, spec, lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("name", ["qwen3-0.6b", "gemma2-9b"])
def test_reduced_serve_path_matches(name):
    """Prefill logits, every teacher-forced decode step's logits, and the
    served greedy tokens. The prompt (136) is above the flash block (128)
    and not a multiple of it, so prefill goes through the padding path;
    gemma2 adds its window (16, alternating), attention and final softcaps,
    sandwich norms, GeGLU and embedding scale."""
    jspec, jp, spec, p = _model(name)
    assert param_count(p) == jparam_count(jp)
    rng = np.random.default_rng(11)
    b, s, steps, cache_len = 2, 136, 6, 150
    prompts = rng.integers(1, spec.cfg.vocab, size=(b, s))
    forced = rng.integers(1, spec.cfg.vocab, size=(b, steps))
    want, jcaches = jspec.prefill(jp, jnp.asarray(prompts, jnp.int32), cache_len)
    got, caches = spec.prefill(p, torch.as_tensor(prompts), cache_len)
    assert tuple(got.shape) == (b, spec.cfg.vocab)
    _close(got, want)
    decode = jax.jit(jspec.decode_step)
    for i in range(steps):
        tok = forced[:, i:i + 1]
        want, jcaches = decode(jp, jnp.asarray(tok, jnp.int32), jcaches, jnp.int32(s + i))
        got, caches = spec.decode_step(p, torch.as_tensor(tok), caches, s + i)
        _close(got, want)
    want_tokens = jserve_batch(jspec, jp, prompts.astype(np.int32), steps, cache_len)
    got_tokens = serve.serve_batch(spec, p, prompts, steps, cache_len)
    np.testing.assert_array_equal(got_tokens, want_tokens)


def test_params_carry_across_in_bf16():
    jspec, jp, spec, p = _model("qwen3-0.6b", dtype=jnp.bfloat16)
    w = p["dense_stack"][1]["attn"]["w_q"]
    assert w.dtype == torch.bfloat16 and len(p["dense_stack"]) == spec.cfg.num_layers
    want = np.asarray(jp["dense_stack"]["attn"]["w_q"][1]).view(np.uint16)
    np.testing.assert_array_equal(w.view(torch.int16).numpy().view(np.uint16), want)
    assert spec.init(0, "cpu")["embed"].dtype == torch.float32     # reduced: f32
    assert get_config("qwen3-0.6b").dtype == torch.bfloat16


def test_port_init_is_seeded():
    spec = build_model(get_config("gemma2-9b").reduced())
    a, b = spec.init(3, "cpu"), spec.init(3, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["dense_stack"][1]["mlp"]["w_down"], b["dense_stack"][1]["mlp"]["w_down"])
    assert not torch.equal(a["embed"], spec.init(4, "cpu")["embed"])


def test_serve_main_on_the_cpu(capsys):
    serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                "--requests", "3", "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert out.count("batch done") == 2 and "served 3 requests / 9 tokens" in out


# ------------------------------------------------------- every config

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_every_arch_builds_with_the_reference_param_count(name):
    """``build_model`` builds each of the ten configs (reduced): its own
    init has the reference's parameter count and dtype, and an unknown
    family raises as the reference's does."""
    jspec = jbuild_model(jget_config(name).reduced())
    want = jparam_count(jax.eval_shape(jspec.init, jax.random.PRNGKey(0)))
    spec = build_model(get_config(name).reduced())
    params = spec.init(0, "cpu")
    assert spec.param_count(params) == param_count(params) == want
    assert params["embed"].dtype == torch.float32
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(spec.cfg, family="nope"))


def test_mla_premap_and_offset_prefill_raise(tmp_path, capsys):
    """MLA, ported now, matches the reference on a prefill at an offset of
    a cache that already holds earlier entries (1e-5, the compressed cache
    too); ``--premap-kernels`` premaps the suite, before serving, as the
    reference does, into a disk cache from which the reference then serves
    every kernel the port mapped (exact counts; a kernel that misses the
    fast profile's 30 s deadline on a loaded host counts as failed in both
    runs)."""
    import re

    from repro.launch.serve import premap_kernels as jpremap_kernels
    from repro.models.attention import MLACache as JMLACache
    from repro.models.attention import mla_attention as jmla_attention
    from repro.models.attention import mla_init as jmla_init

    def counts(out):
        m = re.search(r"premap: 17 kernels on CGRA\(4x4,mesh\) in .* — "
                      r"(\d+) solved, (\d+) cache hits, (\d+) failed", out)
        assert m, out
        return tuple(int(g) for g in m.groups())

    jcfg, cfg = jget_config("deepseek-v3-671b").reduced(), get_config("deepseek-v3-671b").reduced()
    jp = jmla_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    old = _rand(2, 16, cfg.mla.kv_lora + cfg.mla.rope_dim, seed=14)
    x, pos = _rand(2, 4, cfg.d_model, seed=15), np.arange(5, 9)
    want, jcache = jmla_attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                  cache=JMLACache(jnp.asarray(old)))
    got, cache = attention.mla_attention(p, _t(x), torch.as_tensor(pos), cfg,
                                         cache=attention.MLACache(_t(old)))
    _close(got, want)
    _close(cache.c_kv, jcache.c_kv)
    cache = str(tmp_path / "maps")
    serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                "--premap-kernels", "4", "--cache-dir", cache,
                "--requests", "1", "--batch", "1", "--prompt-len", "4", "--gen", "2"])
    out = capsys.readouterr().out
    assert out.index("premap:") < out.index("batch done")
    solved, hits, failed = counts(out)
    assert hits == 0 and solved + failed == 17 and solved >= 12
    jpremap_kernels(4, 2, cache)
    assert counts(capsys.readouterr().out)[1] == solved


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the machine without one")
    spec = build_model(get_config("qwen3-0.6b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        spec.init(0)                                   # default: cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3-0.6b", "--reduced"])
