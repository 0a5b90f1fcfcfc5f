"""The port's training path against the JAX package's, on the CPU.

Inputs come from numpy seeds and parameters from the JAX package's init,
carried across with ``repro_torch.interop``; gradients come back through
``interop.lm_params_to_numpy``. Everything runs in f32 (the ``reduced()``
configs). Tolerances:

* loss 1e-5 and each gradient leaf 1e-4 of that leaf's max |g|: the two
  packages differ only in the order of f32 sums (a reduced model's loss
  agrees to ~5e-7 and its gradients to ~2e-6 of max |g|);
* ``lr_at`` and ``adamw_update`` 1e-6, fed identical gradients: AdamW's
  first step is about sign(g), so gradients that differ by 1e-7 near zero
  would move parameters by 2 lr, and multi-step parameters are not compared;
* compression payloads and scales, data batches and checkpoints exactly.

The fault-runner, checkpoint and data cases mirror
tests/test_substrate.py:23-51,114-199.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.configs import get_config as jget_config
from repro.data import MemmapLM as JMemmapLM
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import compress as jcompress
from repro.optim import compress_grads_with_feedback as jcompress_with_feedback
from repro.optim import decompress as jdecompress
from repro.optim import global_norm as jglobal_norm
from repro.optim import lr_at as jlr_at
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.data import MemmapLM, SyntheticLM
from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch import train
from repro_torch.models import build_model, layers
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, compress, compress_grads_with_feedback,
    decompress, global_norm, init_residual, lr_at,
)
from repro_torch.runtime import FaultConfig, run_training
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Small cases: two intra-op threads run them as fast, and leave the
    cores to the tests that other workers run beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol: float) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# --------------------------------------------------------------------- loss

@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_cross_entropy_matches(z_loss):
    logits = _rand(3, 7, 50, seed=1, scale=3.0)
    labels = np.random.default_rng(2).integers(0, 50, size=(3, 7)).astype(np.int32)
    want = jlayers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss)
    got = layers.cross_entropy_loss(_t(logits), _t(labels), z_loss=z_loss)
    _close(got, want, 1e-6)


def _models(name):
    jcfg = jget_config(name).reduced()
    jspec = jbuild_model(jcfg)
    jp = jax.jit(jspec.init)(jax.random.PRNGKey(0))
    spec = build_model(get_config(name).reduced())
    return jspec, jp, spec, lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _loss_and_grads(spec, params, batch):
    flat = [p.detach().clone().requires_grad_() for p in leaves(params)]
    loss, metrics = spec.loss_fn(unflatten(params, flat), batch)
    return loss, metrics, unflatten(params, torch.autograd.grad(loss, flat))


@pytest.mark.parametrize("name", ["qwen3-0.6b", "gemma2-9b"])
def test_loss_and_gradients_match_jax(name):
    """spec.loss_fn and its gradient against jax.value_and_grad of the JAX
    package's, with the same parameters. S 136 is above the flash block and
    not a multiple of it (the padding path); gemma2 adds its window (16,
    alternating), attention and final softcaps, sandwich norms, GeGLU,
    tied embeddings and embedding scale."""
    jspec, jp, spec, p = _models(name)
    rng = np.random.default_rng(5)
    toks = rng.integers(1, spec.cfg.vocab, size=(2, 137)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jspec.loss_fn, has_aux=True))(jp, jbatch)
    loss, metrics, g = _loss_and_grads(
        spec, p, {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])})
    _close(loss.detach(), jloss, 1e-5)
    _close(metrics["ce"].detach(), jm["ce"], 1e-5)
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    got = dict(leaves_with_paths(lm_params_to_numpy(g)))
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jg)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        err = np.abs(got[path] - w).max() / np.abs(w).max()
        assert err <= 1e-4, (path, err)


def test_remat_recomputes_each_layer_and_changes_nothing(monkeypatch):
    """cfg.remat checkpoints every layer: the backward runs each layer's
    attention forward again, and the loss and gradients are the same as
    without remat."""
    _, _, spec, p = _models("qwen3-0.6b")
    calls = {"n": 0}
    lse = flash_mod.flash_attention_lse

    def counted(*args, **kw):
        calls["n"] += 1
        return lse(*args, **kw)

    monkeypatch.setattr(flash_mod, "flash_attention_lse", counted)
    toks = np.random.default_rng(6).integers(1, spec.cfg.vocab, size=(2, 33))
    batch = {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:])}
    assert spec.cfg.remat
    loss, _, g = _loss_and_grads(spec, p, batch)
    assert calls["n"] == 2 * spec.cfg.num_layers
    calls["n"] = 0
    spec_nr = build_model(dataclasses.replace(spec.cfg, remat=False))
    loss_nr, _, g_nr = _loss_and_grads(spec_nr, p, batch)
    assert calls["n"] == spec.cfg.num_layers
    assert torch.equal(loss, loss_nr)
    for a, b in zip(leaves(g), leaves(g_nr)):
        assert torch.equal(a, b)


# -------------------------------------------------------------------- optim

@pytest.mark.parametrize("cfg_kw", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    dict(lr=3e-4, warmup_steps=10, total_steps=8),
    dict(lr=3e-4, warmup_steps=100, total_steps=10_000),
])
def test_lr_schedule_matches(cfg_kw):
    cfg, jcfg = AdamWConfig(**cfg_kw), JAdamWConfig(**cfg_kw)
    for step in (0, 1, 3, 9, 10, 11, 50, 99, 100, 150, 5000, 10_000):
        got = lr_at(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, jlr_at(jcfg, jnp.asarray(step, jnp.int32)), 1e-6)


def _opt_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 5)).astype(dtype),
            "b": {"c": rng.standard_normal(7).astype(dtype),
                  "d": (rng.standard_normal((3, 2)) * 1e-3).astype(dtype)}}


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2, warmup_steps=2, total_steps=6),
    dict(lr=1e-1, warmup_steps=1, total_steps=4, grad_clip=0.5, weight_decay=0.0),
])
def test_adamw_update_matches_given_identical_grads(kw):
    """Three updates, each fed the same numpy gradients on both sides;
    parameters, moments, step and metrics within 1e-6."""
    cfg, jcfg = AdamWConfig(**kw), JAdamWConfig(**kw)
    p_np = _opt_tree(0)
    params = tree_map(_t, p_np)
    jparams = jax.tree.map(jnp.asarray, p_np)
    opt, jopt = adamw_init(params, cfg), jadamw_init(jparams, jcfg)
    for i in range(3):
        g_np = tree_map(lambda a: a * (3.0 if i == 1 else 0.5), _opt_tree(10 + i))
        params, opt, m = adamw_update(tree_map(_t, g_np), opt, params, cfg)
        jparams, jopt, jm = jadamw_update(jax.tree.map(jnp.asarray, g_np), jopt, jparams, jcfg)
        assert int(opt["step"]) == int(jopt["step"]) == i + 1
        for key in ("grad_norm", "lr"):
            _close(m[key], jm[key], 1e-6)
        for got, want in ((params, jparams), (opt["m"], jopt["m"]), (opt["v"], jopt["v"])):
            for a, b in zip(leaves(got), jax.tree.leaves(want)):
                _close(a, b, 1e-6)


def test_adamw_update_keeps_bf16_params_and_leaves_its_inputs():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3)
    params = {"w": torch.randn(16, generator=torch.Generator().manual_seed(0)).bfloat16()}
    before = params["w"].clone()
    opt = adamw_init(params, cfg)
    new, new_opt, _ = adamw_update({"w": torch.ones(16, dtype=torch.bfloat16)}, opt, params, cfg)
    assert new["w"].dtype == torch.bfloat16 and new_opt["m"]["w"].dtype == torch.float32
    assert torch.equal(params["w"], before) and int(opt["step"]) == 0
    assert not torch.equal(new["w"], before)


def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params, cfg)
    for _ in range(150):
        params, opt, _ = adamw_update({"w": 2 * params["w"]}, opt, params, cfg)
    assert float((params["w"] ** 2).sum()) < 1e-3
    assert int(opt["step"]) == 150


def test_global_norm_matches():
    tree = _opt_tree(3)
    _close(global_norm(tree_map(_t, tree)), jglobal_norm(jax.tree.map(jnp.asarray, tree)), 1e-6)


@pytest.mark.parametrize("shape,scale", [((1000,), 1.0), ((3, 300), 1e-3), ((256,), 0.0),
                                         ((7, 256), 50.0)])
def test_compress_payloads_and_scales_equal(shape, scale):
    x = _rand(*shape, seed=4, scale=scale)
    x[..., :3] = [0.5, -0.5, 1.5]            # exact halves: round half to even
    q, s = compress(_t(x))
    jq, js = jcompress(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(decompress(q, s, shape).numpy(),
                                  np.asarray(jdecompress(jq, js, shape)))


def test_error_feedback_matches_over_steps():
    grads = {"w": _rand(1000, seed=7), "b": {"c": _rand(3, 90, seed=8)}}
    g, jg = tree_map(_t, grads), jax.tree.map(jnp.asarray, grads)
    r, jr = init_residual(g), jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), jg)
    for _ in range(4):
        out, r = compress_grads_with_feedback(g, r)
        jout, jr = jcompress_with_feedback(jg, jr)
        for a, b in zip(leaves(out) + leaves(r), jax.tree.leaves(jout) + jax.tree.leaves(jr)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(r["w"].abs().max()) < float(np.abs(grads["w"]).max()) / 100


# --------------------------------------------------------------------- data

@pytest.mark.parametrize("name", ["qwen3-0.6b", "gemma2-9b"])
def test_synthetic_batches_are_bit_identical(name):
    pipe = SyntheticLM(get_config(name).reduced(), batch=4, seq=16, seed=3)
    jpipe = JSyntheticLM(jget_config(name).reduced(), batch=4, seq=16, seed=3)
    for step in range(5):
        got, want = pipe.host_batch(step), jpipe.host_batch(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        on = pipe.batch_at(step, "cpu")
        assert all(torch.equal(on[k], torch.as_tensor(want[k])) for k in want)
    a = pipe.host_batch(5)
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def test_memmap_batches_are_bit_identical(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(10_000, dtype=np.int32).tofile(path)
    pipe = MemmapLM(str(path), get_config("qwen3-0.6b").reduced(), batch=4, seq=16)
    jpipe = JMemmapLM(str(path), jget_config("qwen3-0.6b").reduced(), batch=4, seq=16)
    assert pipe.num_steps == jpipe.num_steps
    for step in (0, 1, 5, pipe.num_steps + 2):
        got, want = pipe.host_batch(step), jpipe.host_batch(step)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    assert pipe.batch_at(1, "cpu")["tokens"].shape == (4, 16)


# --------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip_is_bit_exact_in_bf16(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 3))},
            "w": torch.randn(5, 7, generator=gen).bfloat16(),
            "stack": [{"x": torch.randn(4, generator=gen).bfloat16()},
                      {"x": torch.randn(4, generator=gen).bfloat16()}],
            "step": torch.tensor(7, dtype=torch.int32)}
    save(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert manifest["dtypes"]["w"] == "bfloat16"
    assert manifest["dtypes"]["stack/1/x"] == "bfloat16"
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as data:
        assert data["w"].dtype == np.uint16            # 16 bits, not f32
    got = restore(str(tmp_path), 7, tree)
    for (path, a), (_, b) in zip(leaves_with_paths(got), leaves_with_paths(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_checkpoint_layout_reads_back_in_the_reference(tmp_path):
    """The same npz + manifest layout: the JAX package restores an f32
    checkpoint written by the port, and the port one written by it."""
    tree = {"a": np.arange(10, dtype=np.float32), "b": {"c": np.ones((3, 3), np.float32)}}
    save(str(tmp_path / "port"), 3, tree_map(_t, tree))
    got = jrestore(str(tmp_path / "port"), 3, jax.tree.map(jnp.asarray, tree))
    np.testing.assert_array_equal(np.asarray(got["b"]["c"]), tree["b"]["c"])
    jsave(str(tmp_path / "jax"), 4, jax.tree.map(jnp.asarray, tree))
    got = restore(str(tmp_path / "jax"), 4, tree_map(_t, tree))
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"])


def test_checkpoint_gc_keeps_last(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), s, tree, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    x = {"x": torch.ones(5, dtype=torch.bfloat16)}
    ck.save_async(3, x)
    ck.save_async(4, x)
    ck.wait()
    assert latest_step(str(tmp_path)) == 4
    assert torch.equal(restore(str(tmp_path), 4, x)["x"], x["x"])


# -------------------------------------------------------------- fault runner

def test_fault_runner_restarts_from_checkpoint(tmp_path):
    def step(state, batch):
        return {"w": state["w"] + 1}, {"loss": float(state["w"])}

    boom = {"armed": True}

    def injector(step_i):
        if step_i == 12 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    cfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=5, max_restarts=3)
    state, report = run_training(step, {"w": torch.zeros(())}, lambda s: None, 20, cfg,
                                 fail_injector=injector)
    assert report.restarts == 1
    assert float(state["w"]) == 20  # replay restores exact step count


def test_fault_runner_straggler_accounting(tmp_path):
    import time as _t

    def step(state, batch):
        _t.sleep(0.25 if int(state["i"]) == 15 else 0.002)
        return {"i": state["i"] + 1}, {"loss": 0.0}

    cfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                      straggler_factor=3.0, straggler_grace_steps=5)
    _, report = run_training(step, {"i": torch.zeros((), dtype=torch.int32)},
                             lambda s: None, 20, cfg)
    assert report.straggler_events >= 1


def test_training_restart_replays_the_same_losses(tmp_path):
    """The real training step on reduced qwen3-0.6b: a failure at step 4
    restores the step-3 checkpoint and replays, giving the losses of an
    uninterrupted run; the final states are equal."""
    cfg = get_config("qwen3-0.6b").reduced()
    spec = build_model(cfg)
    opt_cfg = AdamWConfig(total_steps=6, warmup_steps=2)
    data = SyntheticLM(cfg, 2, 32, seed=0)
    runs = []
    for tag, fail_at in (("plain", None), ("failing", 4)):
        armed = {"on": fail_at is not None}

        def injector(step_i):
            if armed["on"] and step_i == fail_at:
                armed["on"] = False
                raise RuntimeError("simulated node failure")

        state = train.make_state(spec, opt_cfg, 0, compression=True, device="cpu")
        step_fn = train.make_step(spec, opt_cfg, compression=True)
        fault = FaultConfig(ckpt_dir=str(tmp_path / tag), ckpt_every=3)
        state, report = run_training(step_fn, state, lambda s: data.batch_at(s, "cpu"), 6,
                                     fault, fail_injector=injector)
        runs.append((state, report))
    (state, report), (state_f, report_f) = runs
    assert report.restarts == 0 and report_f.restarts == 1
    assert report.steps_done == 6 and report_f.steps_done == 7
    assert report_f.losses == report.losses[:4] + report.losses[3:]
    for a, b in zip(leaves(state), leaves(state_f)):
        assert torch.equal(a, b)


def test_make_step_matches_a_jax_step_on_the_loss_and_metrics():
    """One step from the same parameters and batch: loss, ce and the
    gradient norm agree with the JAX step's; the state passed in is left
    as it is (the runner's restart from init_state relies on it)."""
    jspec, jp, spec, p = _models("gemma2-9b")
    opt_kw = dict(total_steps=5, warmup_steps=2)
    toks = np.random.default_rng(9).integers(1, spec.cfg.vocab, size=(2, 41)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    batch = {k: _t(np.asarray(v)) for k, v in jbatch.items()}
    jstate = {"params": jp, "opt": jadamw_init(jp, JAdamWConfig(**opt_kw))}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jspec.loss_fn, has_aux=True))(jp, jbatch)
    update = jax.jit(lambda g, o, q: jadamw_update(g, o, q, JAdamWConfig(**opt_kw)))
    _, _, jom = update(jg, jstate["opt"], jp)
    state = {"params": p, "opt": adamw_init(p, AdamWConfig(**opt_kw))}
    before = [t.clone() for t in leaves(state)]
    new_state, m = train.make_step(spec, AdamWConfig(**opt_kw), compression=False)(state, batch)
    assert sorted(m) == ["aux", "ce", "grad_norm", "loss", "lr"]
    _close(m["loss"], jloss, 1e-5)
    _close(m["ce"], jm["ce"], 1e-5)
    _close(m["grad_norm"], jom["grad_norm"], 1e-5)
    _close(m["lr"], jom["lr"], 1e-6)
    assert int(new_state["opt"]["step"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(leaves(state), before))


# --------------------------------------------------------------- launcher

def test_train_main_on_the_cpu(tmp_path, capsys):
    report = train.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "32",
                         "--ckpt-dir", str(tmp_path), "--grad-compression"])
    assert report.steps_done == 3 and report.restarts == 0
    assert all(np.isfinite(report.losses))
    assert latest_step(str(tmp_path)) == 3
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "device cpu" in out


def test_train_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the machine without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "1"])


def test_params_round_trip_through_numpy():
    _, jp, _, p = _models("qwen3-0.6b")
    back = lm_params_to_numpy(p)
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jp)))
    got = dict(leaves_with_paths(back))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w)
    assert [path for path, _ in leaves_with_paths({"b": [1, 2], "a": {"z": 3, "y": 4}})] \
        == ["a/y", "a/z", "b/0", "b/1"]
