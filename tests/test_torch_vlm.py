"""The port's vision-language family (paligemma-3b) and meta tokens on the
dense path against the JAX package's, on the CPU.

Reduced configs in f32: paligemma-3b's (MQA, GeGLU, tied and scaled
embeddings, 16 prefix embeddings under prefix-LM masking) and a reduced
qwen3-0.6b given ``num_meta_tokens=8`` through ``dataclasses.replace`` (no
config sets meta tokens on the dense path; the reference handles them).
Parameters are made by the reference's init and carried across with
``repro_torch.interop.lm_params_from_numpy``; inputs come from numpy seeds.
Losses within 1e-5, each gradient leaf within 1e-4 of its max |g|, prefill
and decode logits within 1e-4, greedy tokens equal. The vlm's served decode
runs past the end of its cache, as the reference's does: each write's
start is clamped as ``jax.lax.dynamic_update_slice`` clamps it, checked
here exactly. On the CPU the flash-attention wrapper runs its plain
version.
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
from repro.models import param_count as jparam_count
from repro.models.attention import KVCache as JKVCache
from repro.models.attention import MLACache as JMLACache
from repro.models.attention import gqa_attention as jgqa_attention
from repro.models.attention import gqa_init as jgqa_init
from repro.models.attention import mla_attention as jmla_attention
from repro.models.attention import mla_init as jmla_init
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch import serve, train
from repro_torch.models import attention, build_model, param_count
from repro_torch.tree import leaves, leaves_with_paths, unflatten

TOL = 1e-5
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4            # of each leaf's max |g|
VLM = "paligemma-3b"
META = "qwen3-0.6b+meta"   # a reduced qwen3-0.6b with 8 meta tokens
ARCHS = [VLM, META]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small cases: one intra-op thread runs them as fast, and leaves the
    cores to the tests other workers run beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def _reduced(get, name):
    if name == META:
        return dataclasses.replace(get("qwen3-0.6b").reduced(), num_meta_tokens=8)
    return get(name).reduced()


_MODELS = {}


def _model(name):
    """(reference spec, its params, the port's spec, the params carried
    across); built once per module and name."""
    if name not in _MODELS:
        jspec = jbuild_model(_reduced(jget_config, name))
        jp = jax.jit(jspec.init)(jax.random.PRNGKey(0))
        spec = build_model(_reduced(get_config, name))
        _MODELS[name] = (jspec, jp, spec,
                         lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[name]


def _batch(cfg, b=2, s=20, seed=0):
    """Token and label batches for both packages; a vlm batch carries
    ``prefix_embeds`` [b, frontend_len, d_model] as the data pipeline makes
    them."""
    rng = np.random.default_rng(seed)
    host = {"tokens": rng.integers(1, cfg.vocab, size=(b, s)).astype(np.int32),
            "labels": rng.integers(1, cfg.vocab, size=(b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        host["prefix_embeds"] = (rng.standard_normal((b, cfg.frontend_len, cfg.d_model))
                                 * 0.1).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.as_tensor(v) for k, v in host.items()})


# ------------------------------------------------- the clamped cache write

@pytest.mark.parametrize("rows,start", [(1, 9), (3, 5), (1, 5), (2, 0), (3, 2)])
def test_clamped_write_matches_dynamic_update_slice(rows, start):
    """A write of ``rows`` rows at ``start`` into a [6]-slot cache lands
    where ``dynamic_update_slice`` puts it (exact): a 1-row write at 9 in
    slot 5, a 3-row write at 5 in slots 3-5."""
    cache = np.arange(6 * 2, dtype=np.float32).reshape(1, 1, 6, 2)
    block = -np.arange(1, rows * 2 + 1, dtype=np.float32).reshape(1, 1, rows, 2)
    want = jax.lax.dynamic_update_slice(jnp.asarray(cache), jnp.asarray(block),
                                        (0, 0, start, 0))
    got = torch.as_tensor(cache.copy())
    idx = attention.clamped_block_index(torch.arange(start, start + rows), 6)
    got.index_copy_(2, idx, torch.as_tensor(block))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if (rows, start) == (1, 9):
        assert idx.tolist() == [5]
    if (rows, start) == (3, 5):
        assert idx.tolist() == [3, 4, 5]


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_decode_past_the_cache_end_matches(kind):
    """GQA and MLA attention decoding at positions 6, 9 and 11 of a [6]-slot
    cache (whose slots hold earlier writes) match the reference: the write
    clamped into the last slot, rope and the valid mask at the unclamped
    position (1e-5, the cache too)."""
    name = "qwen3-0.6b" if kind == "gqa" else "deepseek-v3-671b"
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    rng = np.random.default_rng(3)
    if kind == "gqa":
        jp = jgqa_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
        shape = (2, cfg.num_kv_heads, 6, cfg.head_dim)
        jcache = JKVCache(*(jnp.asarray(rng.standard_normal(shape), jnp.float32)
                            for _ in range(2)))
    else:
        jp = jmla_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
        shape = (2, 6, cfg.mla.kv_lora + cfg.mla.rope_dim)
        jcache = JMLACache(jnp.asarray(rng.standard_normal(shape), jnp.float32))
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cache = type(jcache)(*(_t(a).clone() for a in jcache))
    jfn, fn = ((jgqa_attention, attention.gqa_attention) if kind == "gqa"
               else (jmla_attention, attention.mla_attention))
    for pos in (6, 9, 11):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jfn(jp, jnp.asarray(x), jnp.asarray([pos]), jcfg, cache=jcache)
        got, cache = fn(p, _t(x), torch.tensor([pos]), cfg, cache=cache)
        _close(got, want)
        for a, b in zip(cache, jcache):
            _close(a, b)


# ------------------------------------------------------------ the models

@pytest.mark.parametrize("name", ARCHS)
def test_params_carry_across_both_ways(name):
    """The reference's tree (meta tokens included) carries across and back
    bit for bit; the port's own init has the same tree and count."""
    jspec, jp, spec, p = _model(name)
    assert param_count(p) == jparam_count(jp)
    assert ("meta_tokens" in p) == (name == META)
    back = dict(jax.tree_util.tree_leaves_with_path(lm_params_to_numpy(p)))
    flat_want = jax.tree_util.tree_leaves_with_path(jp)
    assert len(back) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(back[path], np.asarray(leaf), err_msg=str(path))
    mine = spec.init(0, "cpu")
    assert ([(k, tuple(v.shape), v.dtype) for k, v in leaves_with_paths(mine)]
            == [(k, tuple(v.shape), v.dtype) for k, v in leaves_with_paths(p)])


@pytest.mark.parametrize("name", ARCHS)
def test_loss_matches(name):
    """The loss (the vlm's with 16 prefix embeddings under prefix-LM
    masking; the meta tokens stripped before the head) within 1e-5."""
    jspec, jp, spec, p = _model(name)
    jb, tb = _batch(spec.cfg, seed=1)
    want, jm = jax.jit(jspec.loss_fn)(jp, jb)
    got, m = spec.loss_fn(p, tb)
    _close(got, want)
    assert sorted(m) == sorted(jm) == ["aux", "ce"]
    _close(m["ce"], jm["ce"])


def _grads(spec, p, batch):
    flat = [t.detach().requires_grad_() for t in leaves(p)]
    with torch.enable_grad():
        loss, _ = spec.loss_fn(unflatten(p, flat), batch)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(p, list(grads))


@pytest.mark.parametrize("name", ARCHS)
def test_gradients_match(name):
    """Every gradient leaf (the meta tokens' too) within 1e-4 of its max
    |g| against ``jax.value_and_grad``, with remat on."""
    jspec, jp, spec, p = _model(name)
    assert spec.cfg.remat
    jb, tb = _batch(spec.cfg, seed=2)
    (want, _), jg = jax.jit(jax.value_and_grad(jspec.loss_fn, has_aux=True))(jp, jb)
    loss, g = _grads(spec, p, tb)
    _close(loss, want)
    got = dict(jax.tree_util.tree_leaves_with_path(lm_params_to_numpy(g)))
    nonzero = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        leaf = np.asarray(leaf)
        scale = max(float(np.abs(leaf).max()), 1e-30)
        err = float(np.abs(got[path] - leaf).max()) / scale
        assert err <= GRAD_TOL, f"{jax.tree_util.keystr(path)}: {err}"
        nonzero += bool(np.abs(leaf).max() > 0)
    assert nonzero == len(got)           # every leaf takes part in the loss


def test_prefix_lm_attends_both_ways_within_the_prefix():
    """Moving the last prefix embedding moves the loss through the earlier
    positions' attention (bidirectional within the prefix): the gradient
    wrt the first prefix row depends on the last one, which a causal mask
    would forbid. Checked on the port against the reference's gradient
    wrt the prefix (1e-4 of its max |g|)."""
    jspec, jp, spec, p = _model(VLM)
    jb, tb = _batch(spec.cfg, seed=3)

    def jloss(prefix):
        return jspec.loss_fn(jp, dict(jb, prefix_embeds=prefix))[0]

    want = np.asarray(jax.jit(jax.grad(jloss))(jb["prefix_embeds"]))
    prefix = tb["prefix_embeds"].clone().requires_grad_()
    with torch.enable_grad():
        loss, _ = spec.loss_fn(p, dict(tb, prefix_embeds=prefix))
        (got,) = torch.autograd.grad(loss, prefix)
    _close(got, want, GRAD_TOL * float(np.abs(want).max()))
    causal = build_model(dataclasses.replace(spec.cfg, prefix_lm=False))
    with torch.enable_grad():
        loss, _ = causal.loss_fn(p, dict(tb, prefix_embeds=prefix))
        (other,) = torch.autograd.grad(loss, prefix)
    assert float((other - got).abs().max()) > 1e-3 * float(got.abs().max())


@pytest.mark.parametrize("name", ARCHS)
def test_serve_path_matches(name):
    """Prefill logits, then teacher-forced decode logits at the reference's
    serving positions (after the prompt, the meta tokens and, for the vlm,
    the image prefix: past the end of the vlm's cache, so every write is
    clamped into its last slot) within 1e-4, and the served greedy tokens
    equal."""
    jspec, jp, spec, p = _model(name)
    cfg = spec.cfg
    rng = np.random.default_rng(5)
    b, s, steps = 2, 20, 4
    cache_len = s + steps + 8
    prompts = rng.integers(1, cfg.vocab, size=(b, s))
    forced = rng.integers(1, cfg.vocab, size=(b, steps))
    want, jcaches = jax.jit(jspec.prefill, static_argnums=2)(
        jp, jnp.asarray(prompts, jnp.int32), cache_len)
    got, caches = spec.prefill(p, torch.as_tensor(prompts), cache_len)
    assert tuple(got.shape) == (b, cfg.vocab)
    _close(got, want, LOGIT_TOL)
    base = s + cfg.num_meta_tokens + (cfg.frontend_len if cfg.family == "vlm" else 0)
    assert (base + steps > cache_len) == (name == VLM)
    decode = jax.jit(jspec.decode_step)
    for i in range(steps):
        tok = forced[:, i:i + 1]
        want, jcaches = decode(jp, jnp.asarray(tok, jnp.int32), jcaches, jnp.int32(base + i))
        got, caches = spec.decode_step(p, torch.as_tensor(tok), caches, base + i)
        _close(got, want, LOGIT_TOL)
    jk, jv = np.asarray(jcaches["dense_stack"].k), np.asarray(jcaches["dense_stack"].v)
    for i, c in enumerate(caches["dense_stack"]):
        _close(c.k, jk[i], LOGIT_TOL)
        _close(c.v, jv[i], LOGIT_TOL)
    jspec_jit = dataclasses.replace(jspec, prefill=jax.jit(jspec.prefill, static_argnums=2),
                                    decode_step=decode)
    want_tokens = jserve_batch(jspec_jit, jp, prompts.astype(np.int32), 6, cache_len)
    got_tokens = serve.serve_batch(spec, p, prompts, 6, cache_len)
    np.testing.assert_array_equal(got_tokens, want_tokens)


@pytest.mark.parametrize("name", ARCHS)
def test_make_caches_leaves_room_for_the_prefix(name):
    """``make_caches`` adds the frontend and meta-token rows to the length,
    as the reference's does."""
    jspec, jp, spec, p = _model(name)
    cfg = spec.cfg
    want = jax.eval_shape(lambda: jspec.make_caches(jp, 3, 10))
    got = spec.make_caches(p, 3, 10)
    assert tuple(got["dense_stack"][0].k.shape) == tuple(want["dense_stack"].k.shape[1:])
    assert got["dense_stack"][0].k.shape[2] == 10 + cfg.frontend_len + cfg.num_meta_tokens


def test_flash_runs_on_the_prefill_not_on_prefix_lm_training(monkeypatch):
    """A vlm prefill (text only, causal from position 0) goes through the
    flash wrapper once per layer at the MQA shape; a training pass with
    prefix embeddings (prefix-LM) never does; nor does decode. With meta
    tokens on the dense path (causal over them) both do."""
    calls = []
    real = attention.flash_attention_padded

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention_padded", counting)
    _, _, spec, p = _model(VLM)
    cfg = spec.cfg
    prompts = torch.randint(1, cfg.vocab, (2, 20))
    _, caches = spec.prefill(p, prompts, 30)
    assert calls == [((2, cfg.num_heads, 20, cfg.head_dim),
                      (2, cfg.num_kv_heads, 20, cfg.head_dim))] * cfg.num_layers
    calls.clear()
    spec.decode_step(p, prompts[:, :1], caches, 20 + cfg.frontend_len)
    _grads(spec, p, _batch(cfg, seed=4)[1])
    assert calls == []
    _, _, spec, p = _model(META)
    _grads(spec, p, _batch(spec.cfg, seed=4)[1])
    assert len(calls) == 2 * spec.cfg.num_layers          # the pass and remat's recompute
    assert calls[0][0][2] == 20 + spec.cfg.num_meta_tokens


def test_serve_main_on_the_cpu(capsys):
    serve.main(["--arch", VLM, "--reduced", "--device", "cpu", "--requests", "3",
                "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert out.count("batch done") == 2 and "served 3 requests / 9 tokens" in out


def test_train_main_on_the_cpu(tmp_path, capsys):
    report = train.main(["--arch", VLM, "--reduced", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "16",
                         "--ckpt-dir", str(tmp_path / "ckpt"), "--log-every", "1"])
    assert report.steps_done == 3 and report.restarts == 0
    assert all(np.isfinite(report.losses))
    assert "done: 3 steps" in capsys.readouterr().out
