"""The port's audio family (whisper-small, encoder-decoder) against the JAX
package's, on the CPU.

The reduced config in f32 (2 encoder and 2 decoder layers, d 128, 4 q / 2 kv
heads of 32, 16 frames, 128 learned positions). Parameters are made by the
reference's init and carried across with
``repro_torch.interop.lm_params_from_numpy`` (``enc_layers`` and
``dec_layers`` are lists of per-layer dicts); frames and tokens come from
numpy seeds. ``layer_norm`` within 1e-6, the encoder's output and the loss
within 1e-5, each gradient leaf within 1e-4 of its max |g|, prefill and
decode logits within 1e-4, greedy tokens equal. On the CPU the
flash-attention wrapper runs its plain version.
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
from repro.models import whisper as jwhisper
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve, train
from repro_torch.models import attention, build_model, layers, param_count, whisper
from repro_torch.tree import leaves, leaves_with_paths, unflatten

TOL = 1e-5
LN_TOL = 1e-6
LOGIT_TOL = 1e-4
GRAD_TOL = 1e-4            # of each leaf's max |g|
NAME = "whisper-small"


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


_MODEL = {}


def _model():
    """(reference spec, its params, the port's spec, the params carried
    across); built once per module."""
    if not _MODEL:
        jspec = jbuild_model(jget_config(NAME).reduced())
        jp = jax.jit(jspec.init)(jax.random.PRNGKey(0))
        spec = build_model(get_config(NAME).reduced())
        _MODEL["m"] = (jspec, jp, spec,
                       lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    return _MODEL["m"]


def _frames(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.frontend_len, cfg.d_model)) * 0.1).astype(np.float32)


def _batch(cfg, b=2, s=20, seed=0):
    rng = np.random.default_rng(seed)
    host = {"tokens": rng.integers(1, cfg.vocab, size=(b, s)).astype(np.int32),
            "labels": rng.integers(1, cfg.vocab, size=(b, s)).astype(np.int32),
            "frames": _frames(cfg, b, seed + 100)}
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.as_tensor(v) for k, v in host.items()})


@pytest.mark.parametrize("shape,scale", [((3, 5, 64), 1.0), ((2, 7, 768), 30.0)])
def test_layer_norm_matches(shape, scale):
    """Weights and biases away from 1 and 0, inputs off centre."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * scale + 2.0).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = layers.layer_norm(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b))
    _close(got, want, LN_TOL)


def test_sinusoid_equals_the_reference():
    np.testing.assert_array_equal(whisper._sinusoid(1500, 768), jwhisper._sinusoid(1500, 768))


def test_params_carry_across_both_ways():
    """``enc_layers`` and ``dec_layers`` carry across from the reference's
    tree and back (``interop``'s list round trip), bit for bit; the port's
    own init has the same tree, and the reference's count."""
    jspec, jp, spec, p = _model()
    cfg = spec.cfg
    for key in ("enc_layers", "dec_layers"):
        assert isinstance(p[key], list) and len(p[key]) == cfg.num_layers
    assert tuple(p["pos_embed"].shape) == (cfg.max_positions, cfg.d_model)
    assert param_count(p) == jparam_count(jp)
    back = lm_params_to_numpy(p)
    assert isinstance(back["dec_layers"], list)
    flat_want = jax.tree_util.tree_leaves_with_path(jp)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf), err_msg=str(path))
    again = lm_params_from_numpy(back, device="cpu")
    for (ka, a), (kb, b) in zip(leaves_with_paths(again), leaves_with_paths(p)):
        assert ka == kb and torch.equal(a, b)
    mine = spec.init(0, "cpu")
    assert ([(k, tuple(v.shape), v.dtype) for k, v in leaves_with_paths(mine)]
            == [(k, tuple(v.shape), v.dtype) for k, v in leaves_with_paths(p)])


def test_encoder_matches():
    """The encoder alone (sinusoid positions, bidirectional attention,
    LayerNorms) over random frames."""
    jspec, jp, spec, p = _model()
    frames = _frames(spec.cfg, seed=2)
    want = jax.jit(jwhisper.whisper_encode, static_argnums=1)(jp, jspec.cfg, jnp.asarray(frames))
    got = whisper.whisper_encode(p, spec.cfg, torch.as_tensor(frames))
    assert tuple(got.shape) == frames.shape
    _close(got, want)


def test_loss_matches():
    jspec, jp, spec, p = _model()
    jb, tb = _batch(spec.cfg, seed=3)
    want, jm = jax.jit(jspec.loss_fn)(jp, jb)
    got, m = spec.loss_fn(p, tb)
    _close(got, want)
    assert sorted(m) == sorted(jm) == ["ce"]


def _grads(spec, p, batch):
    flat = [t.detach().requires_grad_() for t in leaves(p)]
    with torch.enable_grad():
        loss, _ = spec.loss_fn(unflatten(p, flat), batch)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(p, list(grads))


def test_gradients_match():
    """Every gradient leaf within 1e-4 of its max |g| against
    ``jax.value_and_grad``, with remat on; the rows of ``pos_embed`` past
    the sequence get none, as in the reference."""
    jspec, jp, spec, p = _model()
    assert spec.cfg.remat
    jb, tb = _batch(spec.cfg, seed=4)
    (want, _), jg = jax.jit(jax.value_and_grad(jspec.loss_fn, has_aux=True))(jp, jb)
    loss, g = _grads(spec, p, tb)
    _close(loss, want)
    got = dict(jax.tree_util.tree_leaves_with_path(lm_params_to_numpy(g)))
    assert len(got) == len(jax.tree.leaves(jg))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        leaf = np.asarray(leaf)
        scale = max(float(np.abs(leaf).max()), 1e-30)
        err = float(np.abs(got[path] - leaf).max()) / scale
        assert err <= GRAD_TOL, f"{jax.tree_util.keystr(path)}: {err}"
    assert float(np.abs(got[(jax.tree_util.DictKey("pos_embed"),)][20:]).max()) == 0


def test_serve_path_matches():
    """Prefill logits (random frames), then teacher-forced decode logits at
    positions after the prompt, within 1e-4; the served greedy tokens (zero
    frames, as ``serve_batch`` prefills) equal."""
    jspec, jp, spec, p = _model()
    cfg = spec.cfg
    rng = np.random.default_rng(5)
    b, s, steps, cache_len = 2, 20, 4, 32
    prompts = rng.integers(1, cfg.vocab, size=(b, s))
    forced = rng.integers(1, cfg.vocab, size=(b, steps))
    frames = _frames(cfg, b, seed=6)
    want, jcaches = jax.jit(jspec.prefill, static_argnums=2)(
        jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(prompts, jnp.int32)},
        cache_len)
    got, caches = spec.prefill(p, {"frames": torch.as_tensor(frames),
                                   "tokens": torch.as_tensor(prompts)}, cache_len)
    assert tuple(got.shape) == (b, cfg.vocab)
    _close(got, want, LOGIT_TOL)
    decode = jax.jit(jspec.decode_step)
    for i in range(steps):
        tok = forced[:, i:i + 1]
        want, jcaches = decode(jp, jnp.asarray(tok, jnp.int32), jcaches, jnp.int32(s + i))
        got, caches = spec.decode_step(p, torch.as_tensor(tok), caches, s + i)
        _close(got, want, LOGIT_TOL)
    for mine, ref in zip(caches.self_kv, jcaches.self_kv):
        _close(mine.k, ref.k, LOGIT_TOL)
        _close(mine.v, ref.v, LOGIT_TOL)
    for mine, ref in zip(caches.cross_kv, jcaches.cross_kv):
        _close(mine[0], ref[0], LOGIT_TOL)
    jspec_jit = dataclasses.replace(jspec, prefill=jax.jit(jspec.prefill, static_argnums=2),
                                    decode_step=decode)
    want_tokens = jserve_batch(jspec_jit, jp, prompts.astype(np.int32), 6, cache_len)
    got_tokens = serve.serve_batch(spec, p, prompts, 6, cache_len)
    np.testing.assert_array_equal(got_tokens, want_tokens)


@pytest.mark.parametrize("pos", [7, 130])
def test_decode_step_matches_on_its_own(pos):
    """One decode step from caches the reference made (its ``make_caches``
    of random contents carried across): at position 7, and at 130, past
    the 128 learned positions and the 16-slot cache, where the position
    read and the cache write clamp as the reference's do."""
    jspec, jp, spec, p = _model()
    cfg = spec.cfg
    rng = np.random.default_rng(7)
    jcaches = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        jspec.make_caches(jp, 2, 16))
    caches = whisper.WhisperCaches(
        [attention.KVCache(*(torch.as_tensor(np.array(t)) for t in c))
         for c in jcaches.self_kv],
        [tuple(torch.as_tensor(np.array(t)) for t in c) for c in jcaches.cross_kv])
    assert tuple(caches.cross_kv[0][0].shape) == (2, cfg.num_kv_heads, cfg.frontend_len,
                                                  cfg.head_dim)
    mine = spec.make_caches(p, 2, 16)
    assert ([tuple(t.shape) for c in mine.self_kv + mine.cross_kv for t in c]
            == [tuple(t.shape) for c in caches.self_kv + caches.cross_kv for t in c])
    tok = rng.integers(1, cfg.vocab, size=(2, 1))
    want, jnew = jax.jit(jspec.decode_step)(jp, jnp.asarray(tok, jnp.int32), jcaches,
                                            jnp.int32(pos))
    got, new = spec.decode_step(p, torch.as_tensor(tok), caches, pos)
    _close(got, want, LOGIT_TOL)
    for a, b in zip(new.self_kv, jnew.self_kv):
        _close(a.k, b.k, LOGIT_TOL)


def test_flash_runs_on_the_decoder_self_attention_only(monkeypatch):
    """A prefill goes through the flash wrapper once per decoder layer, at
    the prompt's shape (never for the encoder or the cross-attention); a
    training pass with remat twice per decoder layer (the pass and the
    recompute); decode never."""
    calls = []
    real = attention.flash_attention_padded

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention_padded", counting)
    _, _, spec, p = _model()
    cfg = spec.cfg
    before = flash_attention.launches
    batch = serve.prefill_batch(cfg, torch.randint(1, cfg.vocab, (2, 20)))
    _, caches = spec.prefill(p, batch, 30)
    assert calls == [((2, cfg.num_heads, 20, cfg.head_dim),
                      (2, cfg.num_kv_heads, 20, cfg.head_dim))] * cfg.num_layers
    calls.clear()
    spec.decode_step(p, batch["tokens"][:, :1], caches, 20)
    assert calls == []
    _grads(spec, p, _batch(cfg, s=24, seed=8)[1])
    assert len(calls) == 2 * cfg.num_layers
    assert flash_attention.launches == before              # CPU: no kernel


def test_serve_main_on_the_cpu(capsys):
    serve.main(["--arch", NAME, "--reduced", "--device", "cpu", "--requests", "3",
                "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    out = capsys.readouterr().out
    assert out.count("batch done") == 2 and "served 3 requests / 9 tokens" in out


def test_train_main_on_the_cpu(tmp_path, capsys):
    report = train.main(["--arch", NAME, "--reduced", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "16",
                         "--ckpt-dir", str(tmp_path / "ckpt"), "--log-every", "1"])
    assert report.steps_done == 3 and report.restarts == 0
    assert all(np.isfinite(report.losses))
    assert "done: 3 steps" in capsys.readouterr().out
