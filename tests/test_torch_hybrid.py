"""The port's SSM and hybrid families (xlstm-125m, hymba-1.5b) against the
JAX package's, on the CPU.

Reduced configs in f32; hymba at 5 layers, not ``reduced()``'s 2, so that
layers 1 and 3 use the sliding window (0, 2 and 4 are global) and a prompt
longer than the window plus the meta tokens tests it. Parameters are made by
the reference's init and carried across with
``repro_torch.interop.lm_params_from_numpy`` (the families keep their
layers as a list). Losses within 1e-5, each gradient leaf within 1e-4 of its
max |g|, prefill and decode logits within 1e-4 (the chunked recurrence's
tolerance), greedy tokens equal. On the CPU the flash-attention wrapper runs
its plain version.
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
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve, train
from repro_torch.models import attention, build_model, param_count
from repro_torch.models.build import layer_windows
from repro_torch.tree import leaves, leaves_with_paths, unflatten

TOL = 1e-5
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4            # of each leaf's max |g|
ARCHS = ["xlstm-125m", "hymba-1.5b"]
HYMBA_LAYERS = 5


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


def _reduced(get, name):
    cfg = get(name).reduced()
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=HYMBA_LAYERS)
    return cfg


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


def _batch(vocab, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, size=(b, s)), rng.integers(1, vocab, size=(b, s))


def test_hymba_reduced_has_windowed_and_global_layers():
    cfg = _reduced(get_config, "hymba-1.5b")
    w = layer_windows(cfg, cfg.num_layers)
    assert w.tolist() == [0, 16, 0, 16, 0]
    assert cfg.sliding_window + cfg.num_meta_tokens < 24 + cfg.num_meta_tokens


@pytest.mark.parametrize("name", ARCHS)
def test_params_carry_across_both_ways(name):
    """The ``layers`` list carries across from the reference's tree and
    back, bit for bit; the port's own init has the same tree."""
    jspec, jp, spec, p = _model(name)
    assert isinstance(p["layers"], list) and len(p["layers"]) == spec.cfg.num_layers
    assert param_count(p) == jparam_count(jp)
    back = lm_params_to_numpy(p)
    assert isinstance(back["layers"], list)
    flat_want = jax.tree_util.tree_leaves_with_path(jp)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf), err_msg=str(path))
    mine = spec.init(0, "cpu")
    assert ([(k, tuple(v.shape), v.dtype) for k, v in leaves_with_paths(mine)]
            == [(k, tuple(v.shape), v.dtype) for k, v in leaves_with_paths(p)])


def test_layer_lists_round_trip_in_bf16():
    """A bf16 ``layers`` list (with an f32 leaf, as SSD keeps ``a_log``)
    goes to numpy and back with the dtypes kept where numpy has them."""
    rng = np.random.default_rng(1)
    tree = {"embed": rng.standard_normal((8, 4)).astype(np.float32),
            "layers": [{"w": rng.standard_normal((4, 4)).astype(np.float32),
                        "ssd": {"a_log": np.zeros(3, np.float32)}} for _ in range(3)]}
    p = lm_params_from_numpy(tree, device="cpu")
    p["layers"][1]["w"] = p["layers"][1]["w"].to(torch.bfloat16)
    back = lm_params_to_numpy(p)
    assert isinstance(back["layers"], list) and len(back["layers"]) == 3
    for i in range(3):
        np.testing.assert_array_equal(
            back["layers"][i]["w"],
            tree["layers"][i]["w"] if i != 1 else
            torch.as_tensor(tree["layers"][1]["w"]).to(torch.bfloat16).float().numpy())
        assert back["layers"][i]["ssd"]["a_log"].dtype == np.float32
    assert lm_params_from_numpy(back, device="cpu")["layers"][2]["w"].dtype == torch.float32


@pytest.mark.parametrize("name", ARCHS)
def test_loss_matches(name):
    jspec, jp, spec, p = _model(name)
    tokens, labels = _batch(spec.cfg.vocab, seed=2)
    want, jm = jax.jit(jspec.loss_fn)(jp, {"tokens": jnp.asarray(tokens, jnp.int32),
                                          "labels": jnp.asarray(labels, jnp.int32)})
    got, m = spec.loss_fn(p, {"tokens": torch.as_tensor(tokens),
                              "labels": torch.as_tensor(labels)})
    _close(got, want)
    assert sorted(m) == sorted(jm) == ["ce"]
    _close(m["ce"], jm["ce"])


def _grads(spec, p, tokens, labels):
    flat = [t.detach().requires_grad_() for t in leaves(p)]
    with torch.enable_grad():
        loss, _ = spec.loss_fn(unflatten(p, flat), {"tokens": torch.as_tensor(tokens),
                                                    "labels": torch.as_tensor(labels)})
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(p, list(grads))


@pytest.mark.parametrize("name", ARCHS)
def test_gradients_match(name):
    """Every gradient leaf (the meta tokens', the gates', a_log's) within
    1e-4 of its max |g| against ``jax.value_and_grad``, with remat on."""
    jspec, jp, spec, p = _model(name)
    assert spec.cfg.remat
    tokens, labels = _batch(spec.cfg.vocab, seed=3)
    (want, _), jg = jax.jit(jax.value_and_grad(jspec.loss_fn, has_aux=True))(
        jp, {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)})
    loss, g = _grads(spec, p, tokens, labels)
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


@pytest.mark.parametrize("name", ARCHS)
def test_remat_on_and_off_give_the_same_step(name):
    """One training step through ``launch.train.make_step`` with remat on
    and off: the same loss and new parameters."""
    from repro_torch.optim import AdamWConfig

    _, _, spec, p = _model(name)
    tokens, labels = _batch(spec.cfg.vocab, seed=4)
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


@pytest.mark.parametrize("name", ARCHS)
def test_serve_path_matches(name):
    """Prefill logits, three teacher-forced decode steps (hymba's at
    positions after its meta tokens), and the served greedy tokens."""
    jspec, jp, spec, p = _model(name)
    cfg = spec.cfg
    rng = np.random.default_rng(5)
    b, s, cache_len = 2, 24, 32
    prompts = rng.integers(1, cfg.vocab, size=(b, s))
    forced = rng.integers(1, cfg.vocab, size=(b, 3))
    want, jcaches = jax.jit(jspec.prefill, static_argnums=2)(
        jp, jnp.asarray(prompts, jnp.int32), cache_len)
    got, caches = spec.prefill(p, torch.as_tensor(prompts), cache_len)
    _close(got, want, LOGIT_TOL)
    decode = jax.jit(jspec.decode_step)
    base = s + cfg.num_meta_tokens
    for i in range(3):
        tok = forced[:, i:i + 1]
        want, jcaches = decode(jp, jnp.asarray(tok, jnp.int32), jcaches, jnp.int32(base + i))
        got, caches = spec.decode_step(p, torch.as_tensor(tok), caches, base + i)
        _close(got, want, LOGIT_TOL)
    jspec_jit = dataclasses.replace(jspec, prefill=jax.jit(jspec.prefill, static_argnums=2),
                                    decode_step=decode)
    want_tokens = jserve_batch(jspec_jit, jp, prompts.astype(np.int32), 4, cache_len)
    got_tokens = serve.serve_batch(spec, p, prompts, 4, cache_len)
    np.testing.assert_array_equal(got_tokens, want_tokens)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_carries_the_state_of_a_longer_prefill(name):
    """A prefill of the prompt, then one decode step of the next token,
    gives the logits of a prefill of the prompt with that token appended:
    the recurrent states and the offset KV cache carry over."""
    _, _, spec, p = _model(name)
    cfg = spec.cfg
    prompts = np.random.default_rng(6).integers(1, cfg.vocab, size=(2, 25))
    _, caches = spec.prefill(p, torch.as_tensor(prompts[:, :-1]), 32)
    got, _ = spec.decode_step(p, torch.as_tensor(prompts[:, -1:]), caches,
                              24 + cfg.num_meta_tokens)
    want, _ = spec.prefill(p, torch.as_tensor(prompts), 32)
    _close(got, want.numpy(), LOGIT_TOL)


def test_hymba_prefill_and_training_call_the_flash_wrapper(monkeypatch):
    """A hymba prefill goes through the flash wrapper once per layer, over
    the meta tokens and the prompt, with each layer's window; a training
    pass with remat once per layer and again in the recompute; decode
    never."""
    calls = []
    real = attention.flash_attention_padded

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw.get("window")))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention_padded", counting)
    _, _, spec, p = _model("hymba-1.5b")
    cfg = spec.cfg
    before = flash_attention.launches
    prompts = torch.randint(1, cfg.vocab, (2, 24))
    _, caches = spec.prefill(p, prompts, 30)
    s = 24 + cfg.num_meta_tokens
    assert calls == [((2, cfg.num_heads, s, cfg.head_dim),
                      (2, cfg.num_kv_heads, s, cfg.head_dim), w)
                     for w in (None, 16, None, 16, None)]
    assert tuple(caches.kv[0].k.shape) == (2, cfg.num_kv_heads, 30 + cfg.num_meta_tokens,
                                           cfg.head_dim)
    calls.clear()
    spec.decode_step(p, prompts[:, :1], caches, s)
    assert calls == []
    _grads(spec, p, *_batch(cfg.vocab, s=20, seed=7))
    assert len(calls) == 2 * cfg.num_layers
    assert flash_attention.launches == before              # CPU: no kernel


@pytest.mark.parametrize("name", ARCHS)
def test_serve_main_on_the_cpu(name, capsys):
    serve.main(["--arch", name, "--reduced", "--device", "cpu", "--requests", "3",
                "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    out = capsys.readouterr().out
    assert out.count("batch done") == 2 and "served 3 requests / 9 tokens" in out


@pytest.mark.parametrize("name", ARCHS)
def test_train_main_on_the_cpu(name, tmp_path, capsys):
    report = train.main(["--arch", name, "--reduced", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "24",
                         "--ckpt-dir", str(tmp_path / "ckpt"), "--log-every", "1"])
    assert report.steps_done == 3 and report.restarts == 0
    assert all(np.isfinite(report.losses))
    assert "done: 3 steps" in capsys.readouterr().out
