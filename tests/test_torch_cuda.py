"""The CUDA kernels against their plain PyTorch versions, on a GPU.

Needs a CUDA GPU and the CUDA toolkit; skipped elsewhere. Run on the card
with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
Imports nothing of JAX, so it runs where JAX is not installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import CGRA, map_dfg, running_example
from repro_torch.core.benchsuite import load_suite
from repro_torch.configs import get_config
from repro_torch.kernels.cgra_sim import cgra_sim, cgra_sim_torch
from repro_torch.kernels.flash_attention import (
    _FlashAttention, flash_attention, flash_attention_backward,
    flash_attention_backward_torch, flash_attention_lse, flash_attention_padded,
    flash_attention_torch,
)
from repro_torch.kernels.ops import cgra_run, compile_program
from repro_torch.kernels.ref import cgra_sim_reference
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.serve import serve_batch
from repro_torch.models import attention, build_model
from repro_torch.optim import AdamWConfig
from repro_torch.tree import leaves, unflatten

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _program(dfg, grid):
    res = map_dfg(dfg, CGRA(*grid), deterministic=True)
    assert res.ok, res.reason
    return compile_program(res.mapping)


@pytest.mark.parametrize("case", [("running_example", (2, 2), 5, 8),
                                  ("running_example", (4, 4), 4, 100),
                                  ("gsm", (4, 4), 7, 257)])
def test_kernel_matches_plain_and_oracle(cuda, case):
    name, grid, num_iters, batch = case
    dfg = running_example() if name == "running_example" else load_suite([name])[name]
    prog = _program(dfg, grid)
    rng = np.random.default_rng(0)
    inputs = {v: rng.uniform(-4, 4, (num_iters, batch)).astype(np.float32)
              for v in prog.input_nodes()}
    before = cgra_sim.launches
    outs, trace = cgra_run(prog, inputs, num_iters)          # default: CUDA
    assert cgra_sim.launches == before + 1
    assert trace.device.type == "cuda"
    tables = prog.sim_tables().to(cuda)
    x = torch.stack([torch.as_tensor(inputs[v], device=cuda)
                     for v in prog.input_nodes()])
    assert torch.equal(trace, cgra_sim_torch(tables, x))
    _, ref = cgra_sim_reference(prog, inputs, num_iters)
    np.testing.assert_array_equal(trace.cpu().numpy(), ref)


def test_kernel_rejects_bad_input(cuda):
    prog = _program(running_example(), (2, 2))
    tables = prog.sim_tables().to(cuda)
    x = torch.zeros((tables.num_inputs, 3, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        cgra_sim(tables, x.double())
    with pytest.raises(ValueError, match="table"):
        cgra_sim(prog.sim_tables(), x)                        # tables on the host
    with pytest.raises(ValueError, match="contiguous"):
        cgra_sim(tables, x.transpose(1, 2).contiguous().transpose(1, 2))


def test_compile_pool_forks_after_cuda(cuda, tmp_path):
    """The compile pool forks (the default context on Linux) from a process
    that already holds a CUDA context; the workers never touch CUDA, so
    every job comes back, and a second pool reads what the first wrote."""
    from repro_torch.api import Compiler, resolve_options
    from repro_torch.core.mapper import clear_mapping_cache

    x = torch.ones(4, device=cuda) * 2
    torch.cuda.synchronize()
    suite = list(load_suite(["bitcount", "fft", "gsm", "aes"]).values())
    comp = Compiler(CGRA(4, 4), resolve_options("fast", jobs=2, deadline_s=30.0,
                                                cache_dir=str(tmp_path)))
    cold = comp.compile_batch(suite)
    assert cold.ok and cold.num_workers == 2 and cold.cache_counters["solved"] == 4
    clear_mapping_cache()
    warm = comp.compile_batch(suite)
    assert warm.ok and warm.cache_counters["disk_hits"] == 4
    assert float(x.sum()) == 8.0                 # the parent's context still works


def test_anneal_50x50_mapping_runs_on_the_card(cuda):
    """A mapping of the annealing engine on the 2500-PE preset, through the
    API, executed by the kernel: equal to the plain version and the oracle."""
    from repro_torch.api import Compiler

    res = Compiler("mesh_50x50", "deterministic-ci").compile(
        load_suite(["backprop"])["backprop"])
    assert res.ok and res.space_backend == "anneal"
    prog = compile_program(res.mapping)
    num_iters, batch = 6, 300
    rng = np.random.default_rng(0)
    inputs = {v: rng.uniform(-4, 4, (num_iters, batch)).astype(np.float32)
              for v in prog.input_nodes()}
    _, trace = cgra_run(prog, inputs, num_iters)
    tables = prog.sim_tables().to(cuda)
    x = torch.stack([torch.as_tensor(inputs[v], device=cuda)
                     for v in prog.input_nodes()])
    assert torch.equal(trace, cgra_sim_torch(tables, x))
    _, ref = cgra_sim_reference(prog, inputs, num_iters, lanes=[0, 7, 299])
    np.testing.assert_array_equal(trace[:, :, [0, 7, 299]].cpu().numpy(), ref)


def test_daemon_threads_solve_with_z3_at_once(tmp_path):
    """The compile daemon's worker threads solve at once with z3 as the time
    backend (``auto`` takes it wherever it is importable, as on the GPU
    machine): each z3 backend works in a context of its own, so the process
    survives and every row maps."""
    pytest.importorskip("z3")
    from repro_torch.core.daemon import CompileDaemon
    from repro_torch.core.time_backends import resolve_backend_name

    assert resolve_backend_name("auto") == "z3"
    names = ["bitcount", "fft", "gsm", "crc32", "sha2", "aes", "basicmath", "backprop"]
    suite = load_suite(names)
    with CompileDaemon(CGRA(8, 8), "fast", workers=4,
                       cache_dir=str(tmp_path / "cache")) as d:
        tickets = [d.submit(suite[n], tenant=n) for n in names]
        rows = [t.wait(timeout=300) for t in tickets]
    assert all(r is not None and r["ok"] for r in rows), rows
    assert all("z3" in r["backend"] for r in rows), [r["backend"] for r in rows]
    assert d.stats.solves == len(names) and d.stats.failed == 0


@pytest.mark.parametrize("fabric", [dict(rows=3, cols=3),
                                    dict(rows=4, cols=4, topology="torus"),
                                    dict(rows=4, cols=4, topology="one-hop")],
                         ids=["mesh3x3", "torus4x4", "onehop4x4"])
def test_fuzz_chunk_runs_on_the_card(cuda, fabric):
    """One chunk of the fuzz harness's seeds (0-16), mapped deterministically
    by the exact engine with the harness's budgets and executed by the
    kernel at 4096 lanes x 32 iterations: each trace equals the plain version
    and sampled lanes the oracle (NaN for NaN, should a program overflow)."""
    from repro_torch.core.fuzz import random_dfg
    from repro_torch.core.simulate import check_equivalence

    num_iters, batch, mapped = 32, 4096, 0
    for seed in range(17):
        res = map_dfg(random_dfg(seed), CGRA(**fabric), space_backend="exact",
                      deterministic=True, use_cache=False, det_space_cap=4000,
                      max_retries_per_window=1, max_slack=1)
        if not res.ok:
            continue
        mapped += 1
        check_equivalence(res.mapping)
        prog = compile_program(res.mapping)
        rng = np.random.default_rng(seed)
        inputs = {v: rng.uniform(-4, 4, (num_iters, batch)).astype(np.float32).round(2)
                  for v in prog.input_nodes()}
        before = cgra_sim.launches
        _, trace = cgra_run(prog, inputs, num_iters)
        assert cgra_sim.launches == before + 1
        tables = prog.sim_tables().to(cuda)
        x = (torch.stack([torch.as_tensor(inputs[v], device=cuda)
                          for v in prog.input_nodes()]) if inputs
             else torch.zeros((0, num_iters, 1), device=cuda))
        plain = cgra_sim_torch(tables, x)
        assert bool(((trace == plain) | (trace.isnan() & plain.isnan())).all()), seed
        lanes = [0, 1, trace.shape[2] - 1]
        _, ref = cgra_sim_reference(prog, inputs, num_iters,
                                    lanes=lanes if inputs else None)
        got = trace[:, :, lanes if inputs else [0]].cpu().numpy()
        assert np.array_equal(got, ref, equal_nan=True), seed
    assert mapped > 8


# --------------------------------------------------------- flash attention

def _qkv(b, hq, hkv, s, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape), device=device).to(dtype)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _tensor_core(dtype, d) -> bool:
    """Whether the wrapper takes the tensor-core kernel (else the CUDA-core one)."""
    return dtype != torch.float32 and d in (64, 128, 192, 256)


# f32 within 2e-5 and bf16/f16 within 2e-2: the JAX package's own tolerances
@pytest.mark.parametrize("case", [
    # the CUDA-core kernel: f32 at every D, bf16/f16 at D not a multiple of 64
    ((2, 4, 2, 256, 32), torch.float32, {}),
    ((2, 4, 2, 256, 96), torch.float32, {}),
    ((1, 8, 1, 512, 128), torch.float32, {}),
    ((1, 2, 2, 128, 64), torch.float32, {"causal": False}),
    ((1, 2, 2, 256, 64), torch.float32, {"window": 64, "softcap": 20.0}),
    ((2, 8, 4, 512, 256), torch.float32, {"window": 128, "softcap": 50.0}),
    ((1, 4, 2, 256, 96), torch.bfloat16, {}),
    # the tensor-core kernel at every head dim it takes, in bf16 and f16
    ((1, 4, 2, 256, 64), torch.bfloat16, {}),
    ((1, 4, 2, 256, 64), torch.float16, {}),
    ((1, 4, 2, 256, 128), torch.bfloat16, {}),
    ((1, 4, 2, 256, 128), torch.float16, {"window": 1000}),
    ((1, 4, 2, 256, 192), torch.bfloat16, {}),
    ((1, 4, 2, 256, 192), torch.float16, {"window": 100}),
    ((2, 8, 4, 512, 256), torch.bfloat16, {"window": 128, "softcap": 50.0}),
    ((1, 4, 2, 384, 256), torch.float16, {}),
    # ... and its options: S below one tile (TMA's zero fill), window,
    # softcap, non-causal, GQA 8/1, all rows masked
    ((2, 4, 2, 48, 64), torch.bfloat16, {}),
    ((2, 4, 2, 48, 128), torch.float16, {"causal": False}),
    ((1, 2, 2, 512, 128), torch.bfloat16, {"window": 64}),
    ((1, 2, 1, 256, 128), torch.bfloat16, {"softcap": 20.0}),
    ((1, 2, 2, 256, 128), torch.bfloat16, {"causal": False}),
    ((1, 2, 2, 256, 64), torch.bfloat16, {"causal": False, "window": 64}),
    ((1, 8, 1, 512, 128), torch.bfloat16, {}),
    ((1, 2, 2, 256, 128), torch.bfloat16, {"window": 0}),
])
def test_flash_kernel_matches_plain(cuda, case):
    shape, dtype, kw = case
    q, k, v = _qkv(*shape, dtype, cuda)
    before = flash_attention.launches
    tc_before = flash_attention.tensor_core_launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    assert (flash_attention.tensor_core_launches - tc_before
            == int(_tensor_core(dtype, shape[-1])))
    torch.cuda.synchronize()
    want = flash_attention_torch(q, k, v, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if kw.get("window") == 0:                  # q - k < 0 never holds causally
        assert torch.equal(got, torch.zeros_like(got))


def test_flash_padded_path_on_the_card(cuda):
    q, k, v = _qkv(1, 4, 2, 1000, 128, torch.bfloat16, cuda)
    tc_before = flash_attention.tensor_core_launches
    got = flash_attention_padded(q, k, v, window=256, softcap=50.0)
    assert flash_attention.tensor_core_launches == tc_before + 1
    want = flash_attention_torch(q, k, v, window=256, softcap=50.0)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_flash_kernel_rejects_bad_input(cuda):
    q, k, v = _qkv(1, 2, 2, 128, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="f32, bf16 or f16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k.half(), v)
    q, k, v = _qkv(1, 2, 2, 128, 48, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        flash_attention(q, k, v)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_reduced_serve_on_the_card_launches_flash(cuda):
    """One kernel launch per layer per prefill; the card's f32 prefill logits
    match the CPU path's (plain attention) within 1e-4."""
    spec = build_model(get_config("gemma2-9b").reduced())
    params = spec.init(0, cuda)
    prompts = np.random.default_rng(1).integers(1, spec.cfg.vocab, size=(2, 136))
    before = flash_attention.launches
    tokens = serve_batch(spec, params, prompts, 4, 150)
    assert flash_attention.launches - before == spec.cfg.num_layers
    assert tokens.shape == (2, 4)
    cpu = _to(params, "cpu")
    got, _ = spec.prefill(params, torch.as_tensor(prompts, device=cuda), 150)
    want, _ = spec.prefill(cpu, torch.as_tensor(prompts), 150)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


# ------------------------------------------------ flash attention backward

def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (over 1 where want is all 0)."""
    return float((got.float() - want.float()).abs().max()
                 / max(float(want.float().abs().max()), 1.0))


def _tensor_core_bwd(dtype, d) -> bool:
    """Whether the backward takes the tensor-core kernels (else the CUDA-core ones)."""
    return dtype != torch.float32 and d in (64, 128)


# f32 within 2e-5 and bf16/f16 within 2e-2 of each gradient's max |g|
@pytest.mark.parametrize("case", [
    # the CUDA-core kernels: f32 at every D, bf16/f16 at D 96, 192, 256
    ((2, 4, 2, 256, 64), torch.float32, {}),
    ((1, 8, 1, 256, 96), torch.float32, {"window": 64, "softcap": 20.0}),
    ((1, 2, 2, 128, 64), torch.float32, {"causal": False}),
    ((2, 8, 4, 512, 256), torch.float32, {"window": 128, "softcap": 50.0}),
    ((1, 4, 2, 256, 96), torch.bfloat16, {}),
    ((1, 4, 2, 256, 192), torch.float16, {"window": 100}),
    ((1, 4, 2, 256, 256), torch.bfloat16, {}),
    # the tensor-core kernels in bf16 and f16 at D 64 and 128: GQA groups 1,
    # 2 and 4, window, softcap, non-causal, S below one tile and ragged,
    # all rows masked
    ((1, 4, 2, 256, 128), torch.bfloat16, {}),
    ((1, 4, 2, 48, 64), torch.float16, {}),
    ((1, 2, 2, 256, 128), torch.bfloat16, {"window": 0}),
    ((2, 4, 4, 256, 64), torch.bfloat16, {}),
    ((1, 8, 2, 384, 128), torch.float16, {"window": 100}),
    ((1, 8, 2, 256, 64), torch.float16, {"softcap": 30.0}),
    ((1, 4, 2, 256, 128), torch.bfloat16, {"window": 64, "softcap": 20.0}),
    ((1, 4, 2, 200, 128), torch.bfloat16, {}),
    ((1, 4, 1, 200, 64), torch.float16, {"causal": False}),
    ((1, 2, 2, 256, 128), torch.float16, {"causal": False, "window": 64}),
    ((2, 4, 2, 48, 128), torch.bfloat16, {"window": 16}),
])
def test_flash_backward_kernel_matches_plain(cuda, case):
    shape, dtype, kw = case
    b, hq, hkv, s, d = shape
    q, k, v = _qkv(*shape, dtype, cuda)
    do = _qkv(b, hq, hkv, s, d, dtype, cuda, seed=1)[0]
    opts = dict(sm_scale=d ** -0.5, **kw)
    o, lse = flash_attention_lse(q, k, v, **opts)
    want_o, want_lse = flash_attention_torch(q, k, v, return_lse=True, **opts)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), want_o.float(), atol=tol, rtol=tol)
    live = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), live)
    torch.testing.assert_close(lse[live], want_lse[live], atol=1e-4, rtol=1e-5)
    before = flash_attention.backward_launches
    tc_before = flash_attention.tensor_core_backward_launches
    got = flash_attention_backward(q, k, v, o, lse, do, **opts)
    assert flash_attention.backward_launches == before + 1
    assert (flash_attention.tensor_core_backward_launches - tc_before
            == int(_tensor_core_bwd(dtype, d)))
    torch.cuda.synchronize()
    want = flash_attention_backward_torch(q, k, v, o, lse, do, **opts)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel_err(g, w) <= tol
    if kw.get("window") == 0:
        assert all(torch.equal(g, torch.zeros_like(g)) for g in got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_backward_is_deterministic(cuda, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    q, k, v = _qkv(2, 8, 2, 640, 128, dtype, cuda, seed=3)
    do = _qkv(2, 8, 2, 640, 128, dtype, cuda, seed=4)[0]
    o, lse = flash_attention_lse(q, k, v, sm_scale=128 ** -0.5, window=300)
    first = flash_attention_backward(q, k, v, o, lse, do, sm_scale=128 ** -0.5, window=300)
    second = flash_attention_backward(q, k, v, o, lse, do, sm_scale=128 ** -0.5, window=300)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_output_keeps_its_gradient_on_the_card(cuda):
    """With grad on, the output's node is the Function's and the gradient
    of a loss through it matches autograd through the plain version."""
    q, k, v = (t.requires_grad_() for t in _qkv(1, 4, 2, 256, 64, torch.float32, cuda))
    before = flash_attention.backward_launches
    out = flash_attention(q, k, v, window=100, softcap=30.0)
    assert type(out.grad_fn) is _FlashAttention._backward_cls
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert flash_attention.backward_launches == before + 1
    plain = flash_attention_torch(q, k, v, window=100, softcap=30.0)
    want = torch.autograd.grad(plain.square().sum(), (q, k, v))
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 2e-5


# --------------------------------------------------------------- training

def _loss_and_grads(spec, params, batch):
    flat = [p.detach().clone().requires_grad_() for p in leaves(params)]
    loss, _ = spec.loss_fn(unflatten(params, flat), batch)
    return loss, unflatten(params, torch.autograd.grad(loss, flat))


def test_gradient_reaches_w_q_on_the_card(cuda, monkeypatch):
    """Reduced qwen3-0.6b in f32 on the card: the loss's gradient reaches
    every layer's w_q, non-zero, through the flash kernels (one backward
    launch per layer), and matches the same loss with the plain attention
    version (autograd through flash_attention_torch) within 1e-4 of each
    leaf's max |g|."""
    spec = build_model(get_config("qwen3-0.6b").reduced())
    params = spec.init(0, cuda)
    toks = np.random.default_rng(2).integers(1, spec.cfg.vocab, size=(2, 137))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device=cuda),
             "labels": torch.as_tensor(toks[:, 1:], device=cuda)}
    before = flash_attention.backward_launches
    loss, grads = _loss_and_grads(spec, params, batch)
    assert flash_attention.backward_launches - before == spec.cfg.num_layers
    monkeypatch.setattr(attention, "flash_attention_padded",
                        lambda q, k, v, **kw: flash_attention_torch(q, k, v, causal=True, **kw))
    plain_loss, plain = _loss_and_grads(spec, params, batch)
    torch.testing.assert_close(loss, plain_loss, atol=1e-5, rtol=1e-5)
    for layer, (got, want) in enumerate(zip(grads["dense_stack"], plain["dense_stack"])):
        assert float(got["attn"]["w_q"].abs().max()) > 0, layer
    for g, w in zip(leaves(grads), leaves(plain)):
        assert _rel_err(g, w) <= 1e-4


def test_reduced_training_step_on_the_card(cuda):
    """make_step on the card: one backward launch per layer per step (the
    forward twice under remat), finite losses, and the first step's loss
    equals the CPU path's within 1e-4."""
    cfg = get_config("qwen3-0.6b").reduced()
    spec = build_model(cfg)
    opt_cfg = AdamWConfig(total_steps=3, warmup_steps=1)
    data = SyntheticLM(cfg, 2, 64, seed=0)
    step = train.make_step(spec, opt_cfg, compression=True)
    state = train.make_state(spec, opt_cfg, 0, compression=True, device=cuda)
    cpu_state = {"params": _to(state["params"], "cpu"), "opt": _to(state["opt"], "cpu"),
                 "residual": _to(state["residual"], "cpu")}
    fwd, bwd = flash_attention.launches, flash_attention.backward_launches
    losses = []
    for i in range(3):
        state, metrics = step(state, data.batch_at(i, cuda))
        losses.append(float(metrics["loss"]))
    assert flash_attention.backward_launches - bwd == 3 * cfg.num_layers
    assert flash_attention.launches - fwd == 2 * 3 * cfg.num_layers
    assert np.isfinite(losses).all()
    _, cpu_metrics = step(cpu_state, data.batch_at(0, "cpu"))
    assert abs(losses[0] - float(cpu_metrics["loss"])) <= 1e-4


def test_reduced_bf16_training_step_runs_the_tensor_core_backward(cuda):
    """Reduced qwen3-0.6b in bf16 at head dim 64 on the card: every layer's
    backward runs the tensor-core kernels, once a step, and the losses are
    finite."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), dtype=torch.bfloat16,
                              head_dim=64)
    spec = build_model(cfg)
    opt_cfg = AdamWConfig(total_steps=2, warmup_steps=1)
    data = SyntheticLM(cfg, 2, 128, seed=0)
    step = train.make_step(spec, opt_cfg, compression=False)
    state = train.make_state(spec, opt_cfg, 0, compression=False, device=cuda)
    tc = flash_attention.tensor_core_backward_launches
    losses = []
    for i in range(2):
        state, metrics = step(state, data.batch_at(i, cuda))
        losses.append(float(metrics["loss"]))
    assert flash_attention.tensor_core_backward_launches - tc == 2 * cfg.num_layers
    assert np.isfinite(losses).all()
