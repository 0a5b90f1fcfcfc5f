"""The port's DeepSeek family (MoE layers, MLA, MTP) against the JAX
package's, on the CPU.

MoE and MLA have no Pallas kernel in the reference: both sides run plain
array ops. Parameters are made by the reference's init and carried across
with ``repro_torch.interop.lm_params_from_numpy``; inputs come from numpy
seeds. In f32 the two packages differ only by the order of f32 sums:
outputs within 1e-5, gates and aux within 1e-6, top-k sets and dispatch
slots equal. On the CPU the flash-attention wrapper runs its plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.serve import serve_batch as jserve_batch
from repro.models import attention as jattention
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.models import param_count as jparam_count
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve, train
from repro_torch.models import attention, build_model, moe, param_count
from repro_torch.tree import leaves, leaves_with_paths, unflatten

TOL = 1e-5
GATE_TOL = 1e-6
BF16_TOL = 2e-2
GRAD_TOL = 1e-4            # of each leaf's max |g|
DEEPSEEK = ["deepseek-moe-16b", "deepseek-v3-671b"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small cases: one intra-op thread runs them as fast, and leaves the
    cores to the tests other workers run beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x) -> torch.Tensor:
    return lm_params_from_numpy({"x": np.asarray(x)}, device="cpu")["x"]


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cfgs(name="deepseek-moe-16b", **moe_kw):
    """The reduced config of ``name`` in both packages, MoE fields replaced."""
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _moe_params(jcfg, dtype=jnp.float32):
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg, dtype)
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# --------------------------------------------------------------- MoE units

@pytest.mark.parametrize("score_fn,normalize,scale", [
    ("softmax", False, 1.0), ("softmax", True, 1.0), ("sigmoid", True, 2.5)])
def test_routing_matches(score_fn, normalize, scale):
    jcfg, cfg = _cfgs(score_fn=score_fn, normalize_gates=normalize, routed_scale=scale)
    jp, p = _moe_params(jcfg)
    x = _rand(64, cfg.d_model, seed=1)
    j_idx, j_gates, j_aux = jax.jit(jmoe._routing, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    idx, gates, aux = moe._routing(p, _t(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    _close(gates, j_gates, GATE_TOL)
    _close(aux, j_aux, GATE_TOL)
    assert gates.dtype == torch.float32 and float(aux) > 0


@pytest.mark.parametrize("capacity", [3, 8, 1000])
def test_dispatch_slots_match_on_ties(capacity):
    """Ids with many ties: the stable sort gives each expert's assignments
    their slots in input order, so the same ones fall past ``capacity``."""
    ids = np.random.default_rng(2).integers(0, 5, size=200)
    j_slots, j_in = jmoe._dispatch_slots(jnp.asarray(ids, jnp.int32), capacity)
    slots, in_cap = moe._dispatch_slots(torch.as_tensor(ids), capacity)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(j_slots))
    np.testing.assert_array_equal(in_cap.numpy(), np.asarray(j_in))
    assert slots.dtype == torch.int32


@pytest.mark.parametrize("factor", [8.0, 0.05])
@pytest.mark.parametrize("shared", [2, 0])
def test_moe_ffn_matches(factor, shared):
    """At 0.05 (capacity 8 for 128 assignments over 8 experts) about half
    the assignments are dropped; the dropped ones are the reference's."""
    jcfg, cfg = _cfgs(capacity_factor=factor, num_shared=shared)
    jp, p = _moe_params(jcfg)
    assert ("shared_gate" in p) == bool(shared)
    x = _rand(2, 32, cfg.d_model, seed=3)
    want, j_aux = jax.jit(jmoe.moe_ffn, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_ffn(p, _t(x), cfg)
    _close(got, want)
    _close(aux, j_aux, GATE_TOL)
    # which assignments were dropped, on each side's own routing
    j_idx, _, _ = jmoe._routing(jp, jnp.asarray(x.reshape(64, -1)), jcfg)
    idx, _, _ = moe._routing(p, _t(x.reshape(64, -1)), cfg)
    capacity = max(8, int(64 * cfg.moe.top_k * factor) // cfg.moe.num_experts)
    _, j_in = jmoe._dispatch_slots(j_idx.reshape(-1), capacity)
    _, in_cap = moe._dispatch_slots(idx.reshape(-1), capacity)
    np.testing.assert_array_equal(in_cap.numpy(), np.asarray(j_in))
    drops = int((~in_cap).sum())
    assert (drops > 30) if factor < 1 else (drops == 0)


def test_moe_ffn_matches_in_bf16():
    jcfg, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jp, p = _moe_params(jcfg, jnp.bfloat16)
    assert p["router"].dtype == torch.float32 and p["expert_up"].dtype == torch.bfloat16
    x = _rand(2, 32, cfg.d_model, seed=4)
    want, j_aux = jax.jit(jmoe.moe_ffn, static_argnums=2)(
        jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    got, aux = moe.moe_ffn(p, _t(x).to(torch.bfloat16), cfg)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), BF16_TOL)
    _close(aux, j_aux, 1e-4)


def test_moe_ffn_is_deterministic_and_seeded():
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(5)
    p = moe.moe_init(gen, cfg, torch.float32, "cpu")
    again = moe.moe_init(torch.Generator().manual_seed(5), cfg, torch.float32, "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    x = _t(_rand(2, 16, cfg.d_model, seed=6))
    a, b = moe.moe_ffn(p, x, cfg)[0], moe.moe_ffn(p, x, cfg)[0]
    assert torch.equal(a, b)


# --------------------------------------------------------------------- MLA

def _mla_case():
    jcfg, cfg = jget_config("deepseek-v3-671b").reduced(), get_config("deepseek-v3-671b").reduced()
    jp = jattention.mla_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jcfg, cfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


jmla = jax.jit(jattention.mla_attention, static_argnames=("cfg",))


def test_mla_prefill_and_decode_match():
    """Without a cache, then a prefill into a cache and two decode steps:
    outputs and the compressed cache within 1e-5."""
    jcfg, cfg, jp, p = _mla_case()
    b, s, cache_len = 2, 20, 24
    x = _rand(b, s + 2, cfg.d_model, seed=7)
    pos = np.arange(s)
    want, _ = jmla(jp, jnp.asarray(x[:, :s]), jnp.asarray(pos), jcfg)
    got, none = attention.mla_attention(p, _t(x[:, :s]), torch.as_tensor(pos), cfg)
    _close(got, want)
    assert none is None
    jcache = jattention.make_mla_cache(jcfg, b, cache_len, jnp.float32)
    cache = attention.make_mla_cache(cfg, b, cache_len, torch.float32, "cpu")
    m = cfg.mla
    assert tuple(cache.c_kv.shape) == (b, cache_len, m.kv_lora + m.rope_dim)
    want, jcache = jmla(jp, jnp.asarray(x[:, :s]), jnp.asarray(pos), jcfg, cache=jcache)
    got, cache = attention.mla_attention(p, _t(x[:, :s]), torch.as_tensor(pos), cfg,
                                         cache=cache)
    _close(got, want)
    _close(cache.c_kv, jcache.c_kv)
    for i in (s, s + 1):
        want, jcache = jmla(jp, jnp.asarray(x[:, i:i + 1]), jnp.asarray([i]), jcfg,
                            cache=jcache)
        got, cache = attention.mla_attention(p, _t(x[:, i:i + 1]), torch.tensor([i]),
                                             cfg, cache=cache)
        _close(got, want)
    _close(cache.c_kv, jcache.c_kv)


def test_mla_blocked_path_matches(monkeypatch):
    """The blocked path in both modules (its threshold lowered so that a
    600-token pass takes it, with a ragged last block), then the blocked
    scores attention itself with a v dim unlike the qk dim."""
    jcfg, cfg, jp, p = _mla_case()
    monkeypatch.setattr(jattention, "_BLOCKED_ATTN_THRESHOLD", 1024)
    monkeypatch.setattr(attention, "_BLOCKED_ATTN_THRESHOLD", 1024)
    x = _rand(1, 600, cfg.d_model, seed=8)
    pos = np.arange(600)
    want, _ = jattention.mla_attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
    got, _ = attention.mla_attention(p, _t(x), torch.as_tensor(pos), cfg)
    _close(got, want)
    qg, k, v = _rand(1, 2, 1, 600, 48, seed=9), _rand(1, 2, 650, 48, seed=10), _rand(1, 2, 650, 32, seed=11)
    q_pos, k_pos = np.arange(50, 650), np.arange(650)
    valid = k_pos <= 640
    kw = dict(scale=48**-0.5, attn_softcap=None, causal=True, window=None, prefix_len=None)
    want = jattention._blocked_scores_attention(
        jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), valid=jnp.asarray(valid), **kw)
    got = attention._blocked_scores_attention(
        _t(qg), _t(k), _t(v), torch.as_tensor(q_pos), torch.as_tensor(k_pos),
        valid=torch.as_tensor(valid), **kw)
    assert tuple(got.shape) == (1, 2, 1, 600, 32)
    _close(got, want)


# ------------------------------------------------------------- whole models

_MODELS = {}


def _model(name):
    """(reference spec, its params, the port's spec, the params carried
    across); built once per module and name."""
    if name not in _MODELS:
        jspec = jbuild_model(jget_config(name).reduced())
        jp = jax.jit(jspec.init)(jax.random.PRNGKey(0))
        spec = build_model(get_config(name).reduced())
        _MODELS[name] = (jspec, jp, spec,
                         lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODELS[name]


def _batch(vocab, b=2, s=24, seed=12):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, size=(b, s)), rng.integers(1, vocab, size=(b, s))


@pytest.mark.parametrize("name", DEEPSEEK)
def test_params_carry_across_both_ways(name):
    """``moe_stack``, the f32 router and the non-stacked ``mtp_*`` leaves
    carry across from the reference's layout and back, bit for bit."""
    jspec, jp, spec, p = _model(name)
    assert param_count(p) == jparam_count(jp)
    cfg = spec.cfg
    assert len(p["dense_stack"]) == cfg.num_dense_layers
    assert len(p["moe_stack"]) == cfg.num_layers - cfg.num_dense_layers
    assert p["moe_stack"][0]["moe"]["router"].dtype == torch.float32
    assert ("mtp_block" in p) == cfg.mtp
    back = lm_params_to_numpy(p)
    flat_want = jax.tree_util.tree_leaves_with_path(jp)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf), err_msg=str(path))
    # the port's own init has the reference's tree
    mine = spec.init(0, "cpu")
    assert sorted(k for k, _ in leaves_with_paths(mine)) == sorted(k for k, _ in leaves_with_paths(p))


@pytest.mark.parametrize("name", DEEPSEEK)
def test_loss_and_metrics_match(name):
    jspec, jp, spec, p = _model(name)
    tokens, labels = _batch(spec.cfg.vocab)
    want, jm = jax.jit(jspec.loss_fn)(jp, {"tokens": jnp.asarray(tokens, jnp.int32),
                                          "labels": jnp.asarray(labels, jnp.int32)})
    got, m = spec.loss_fn(p, {"tokens": torch.as_tensor(tokens),
                              "labels": torch.as_tensor(labels)})
    _close(got, want)
    assert sorted(m) == sorted(jm) == sorted(["ce", "aux"] + (["mtp"] if spec.cfg.mtp else []))
    for key in jm:
        _close(m[key], jm[key])
    assert float(m["aux"]) > 0


def _grads(spec, p, tokens, labels):
    flat = [t.detach().requires_grad_() for t in leaves(p)]
    with torch.enable_grad():
        loss, _ = spec.loss_fn(unflatten(p, flat), {"tokens": torch.as_tensor(tokens),
                                                    "labels": torch.as_tensor(labels)})
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(p, list(grads))


@pytest.mark.parametrize("name", DEEPSEEK)
def test_gradients_match(name):
    """Every gradient leaf (the routers' included: the aux loss carries
    its gradient through remat) within 1e-4 of its max |g| against
    ``jax.value_and_grad``."""
    jspec, jp, spec, p = _model(name)
    assert spec.cfg.remat
    tokens, labels = _batch(spec.cfg.vocab, seed=13)
    (want, _), jg = jax.jit(jax.value_and_grad(jspec.loss_fn, has_aux=True))(
        jp, {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)})
    loss, g = _grads(spec, p, tokens, labels)
    _close(loss, want)
    got = dict(jax.tree_util.tree_leaves_with_path(lm_params_to_numpy(g)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        leaf = np.asarray(leaf)
        scale = max(float(np.abs(leaf).max()), 1e-30)
        err = float(np.abs(got[path] - leaf).max()) / scale
        assert err <= GRAD_TOL, f"{jax.tree_util.keystr(path)}: {err}"
    router = g["moe_stack"][0]["moe"]["router"]
    assert float(router.abs().max()) > 0


@pytest.mark.parametrize("name", DEEPSEEK)
def test_remat_on_and_off_give_the_same_step(name):
    """One training step through ``launch.train.make_step`` with remat on
    and off: the same loss, metrics and new parameters."""
    from repro_torch.optim import AdamWConfig

    _, _, spec, p = _model(name)
    tokens, labels = _batch(spec.cfg.vocab, seed=14)
    batch = {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(labels)}
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1)
    out = []
    for remat in (True, False):
        s = build_model(dataclasses.replace(spec.cfg, remat=remat))
        state = train.make_state(s, opt_cfg, 0, compression=False, device="cpu")
        state["params"] = p
        out.append(train.make_step(s, opt_cfg, compression=False)(state, batch))
    (a, ma), (b, mb) = out
    for key in ma:
        torch.testing.assert_close(ma[key], mb[key], rtol=1e-6, atol=1e-7)
    for x, y in zip(leaves(a["params"]), leaves(b["params"])):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    assert float(ma["aux"]) > 0


@pytest.mark.parametrize("name", DEEPSEEK)
def test_serve_path_matches(name):
    """Prefill logits, two teacher-forced decode steps, and the served
    greedy tokens, against the reference."""
    jspec, jp, spec, p = _model(name)
    rng = np.random.default_rng(15)
    b, s, cache_len = 2, 20, 30
    prompts = rng.integers(1, spec.cfg.vocab, size=(b, s))
    forced = rng.integers(1, spec.cfg.vocab, size=(b, 2))
    want, jcaches = jax.jit(jspec.prefill, static_argnums=2)(
        jp, jnp.asarray(prompts, jnp.int32), cache_len)
    got, caches = spec.prefill(p, torch.as_tensor(prompts), cache_len)
    _close(got, want)
    decode = jax.jit(jspec.decode_step)
    for i in range(2):
        tok = forced[:, i:i + 1]
        want, jcaches = decode(jp, jnp.asarray(tok, jnp.int32), jcaches, jnp.int32(s + i))
        got, caches = spec.decode_step(p, torch.as_tensor(tok), caches, s + i)
        _close(got, want)
    jspec_jit = dataclasses.replace(jspec, prefill=jax.jit(jspec.prefill, static_argnums=2),
                                    decode_step=decode)
    want_tokens = jserve_batch(jspec_jit, jp, prompts.astype(np.int32), 4, cache_len)
    got_tokens = serve.serve_batch(spec, p, prompts, 4, cache_len)
    np.testing.assert_array_equal(got_tokens, want_tokens)


# ------------------------------------------------------------ caps and CLI

def test_moe_model_prefill_calls_the_flash_wrapper(monkeypatch):
    """A causal prefill of the MoE model (GQA) goes through the flash
    wrapper once per layer; MLA (deepseek-v3) never does."""
    calls = []
    real = attention.flash_attention_padded

    def counting(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention_padded", counting)
    before = flash_attention.launches
    for name, want in (("deepseek-moe-16b", 3), ("deepseek-v3-671b", 0)):
        calls.clear()
        spec = build_model(get_config(name).reduced())
        p = spec.init(0, "cpu")
        spec.prefill(p, torch.randint(1, spec.cfg.vocab, (2, 16)), 20)
        assert len(calls) == want == spec.cfg.num_layers * (name == "deepseek-moe-16b")
        if want:
            cfg = spec.cfg
            assert calls[0] == (2, cfg.num_heads, 16, cfg.head_dim)
    assert flash_attention.launches == before              # CPU: no kernel


@pytest.mark.parametrize("name", DEEPSEEK)
def test_serve_main_on_the_cpu(name, capsys):
    serve.main(["--arch", name, "--reduced", "--device", "cpu", "--requests", "3",
                "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert out.count("batch done") == 2 and "served 3 requests / 9 tokens" in out


def test_train_main_on_the_cpu(tmp_path, capsys):
    report = train.main(["--arch", "deepseek-v3-671b", "--reduced", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "16",
                         "--ckpt-dir", str(tmp_path / "ckpt"), "--log-every", "1"])
    assert report.steps_done == 3 and all(np.isfinite(report.losses))
    assert "done: 3 steps" in capsys.readouterr().out
