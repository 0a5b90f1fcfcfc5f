"""The CUDA kernels against their plain PyTorch versions, on a GPU.

Needs a CUDA GPU and the CUDA toolkit; skipped elsewhere. Run on the card
with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
Imports nothing of JAX, so it runs where JAX is not installed.
"""

import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import CGRA, map_dfg, running_example
from repro_torch.core.benchsuite import load_suite
from repro_torch.configs import get_config
from repro_torch.kernels.cgra_sim import cgra_sim, cgra_sim_torch
from repro_torch.kernels.flash_attention import (
    _FlashAttention, flash_attention, flash_attention_backward,
    flash_attention_backward_torch, flash_attention_flops, flash_attention_lse,
    flash_attention_padded, flash_attention_torch,
)
from repro_torch.kernels.ops import _copy_stream, cgra_run, compile_program
from repro_torch.kernels.ref import cgra_sim_reference
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.serve import prefill_batch, serve_batch
from repro_torch.models import attention, build_model
from repro_torch.optim import AdamWConfig
from repro_torch.roofline.analysis import measure_step
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
    tables = prog.tables.to(cuda)
    x = torch.stack([torch.as_tensor(inputs[v], device=cuda)
                     for v in prog.input_nodes()])
    assert torch.equal(trace, cgra_sim_torch(tables, x))
    _, ref = cgra_sim_reference(prog, inputs, num_iters)
    np.testing.assert_array_equal(trace.cpu().numpy(), ref)


def _streams(prog, num_iters, batch, seed=0):
    rng = np.random.default_rng(seed)
    return {v: rng.uniform(-4, 4, (num_iters, batch)).astype(np.float32).round(2)
            for v in prog.input_nodes()}


def _same(outs, trace, want_outs, want_trace):
    assert sorted(outs) == sorted(want_outs)
    assert all(torch.equal(outs[v].cpu(), want_outs[v]) for v in want_outs)
    assert torch.equal(trace.cpu(), want_trace)


@pytest.mark.parametrize("kind", ["numpy", "cpu_tensor", "cuda_tensor"])
@pytest.mark.parametrize("caller", ["current_stream", "side_stream"])
def test_cgra_run_on_the_card_equals_the_cpu_path(cuda, kind, caller):
    """On the caller's stream, default or not, and whatever holds the
    streams: the card's stores and trace equal the CPU path's bit for bit,
    and only calls with host inputs take the copy stream and are staged."""
    prog = _program(load_suite(["gsm"])["gsm"], (4, 4))
    num_iters, batch = 16, 2048
    host = _streams(prog, num_iters, batch)
    want = cgra_run(prog, host, num_iters, device="cpu")
    given = {v: (a if kind == "numpy" else torch.from_numpy(a) if kind == "cpu_tensor"
                 else torch.from_numpy(a).to(cuda)) for v, a in host.items()}
    stream = torch.cuda.Stream() if caller == "side_stream" else torch.cuda.current_stream()
    with obs.tracing() as tracer, torch.cuda.stream(stream):
        outs, trace = cgra_run(prog, given, num_iters)
        stream.synchronize()
    assert tracer.counters.get("exec.copy_stream_calls", 0) == int(kind != "cuda_tensor")
    _same(outs, trace, *want)


def test_cgra_run_is_done_with_the_host_streams_when_it_returns(cuda):
    """The caller may overwrite its host streams as soon as the call
    returns, before the card has run the kernel."""
    prog = _program(load_suite(["gsm"])["gsm"], (4, 4))
    num_iters, batch = 16, 2048
    host = _streams(prog, num_iters, batch, seed=1)
    want = cgra_run(prog, {v: a.copy() for v, a in host.items()}, num_iters, device="cpu")
    pinned = {v: torch.from_numpy(a).pin_memory() for v, a in host.items()}
    got = [cgra_run(prog, host, num_iters), cgra_run(prog, pinned, num_iters)]
    for a in host.values():
        a.fill(np.nan)
    for t in pinned.values():
        t.fill_(float("nan"))
    torch.cuda.synchronize()
    for outs, trace in got:
        _same(outs, trace, *want)


def test_back_to_back_programs_of_other_trace_sizes(cuda):
    """Two programs of different trace sizes called in turns with no
    synchronisation, each call's trace dropped at once: the stores equal
    the CPU path's, so no block of one call was reused under another."""
    progs = [_program(load_suite(["gsm"])["gsm"], (4, 4)), _program(running_example(), (2, 2))]
    shapes = [(16, 2048), (12, 1000)]
    cases = [(p, n, _streams(p, n, b, seed=i)) for i, (p, (n, b)) in enumerate(zip(progs, shapes))]
    want = [cgra_run(p, s, n, device="cpu")[0] for p, n, s in cases]
    sizes = {cgra_run(p, s, n)[1].numel() for p, n, s in cases}
    assert len(sizes) == 2
    got = []
    for _ in range(6):
        for p, n, s in cases:
            outs, _ = cgra_run(p, s, n)
            got.append(outs)
    torch.cuda.synchronize()
    for i, outs in enumerate(got):
        w = want[i % 2]
        assert all(torch.equal(outs[v].cpu(), w[v]) for v in w), f"call {i}"


def _staging_cases():
    """Programs of 2, 4, 5 and 6 inputs, each with its own stream shape."""
    suite = load_suite(["bitcount", "gsm", "backprop"])
    return [(_program(suite["bitcount"], (2, 2)), 9, 4096),
            (_program(suite["gsm"], (4, 4)), 16, 2048),
            (_program(running_example(), (2, 2)), 12, 1000),
            (_program(suite["backprop"], (4, 4)), 20, 512)]


def test_staged_calls_of_other_input_counts_back_to_back(cuda):
    """Calls of other input counts and stream sizes back to back with no
    synchronisation, the copy stream held behind a long sleep and each host
    buffer overwritten with NaN as soon as its call returns: the stores and
    traces equal the CPU path's bit for bit, so no page-locked block was
    rewritten under a copy still in flight. The tables are put on the card
    beforehand, so no pageable copy synchronises the copy stream, and a
    first pass leaves the device memory of every call cached, so no
    allocation does."""
    cases = _staging_cases() * 3
    assert len({len(p.input_nodes()) for p, _, _ in cases}) == 4
    want = [cgra_run(p, _streams(p, n, b, seed=i), n, device="cpu")
            for i, (p, n, b) in enumerate(cases)]
    for p, _, _ in cases[:4]:
        p.tables = p.tables.to(cuda)

    def run_all():
        got = []
        for i, (p, n, b) in enumerate(cases):
            host = _streams(p, n, b, seed=i)
            got.append(cgra_run(p, host, n))
            for a in host.values():
                a.fill(np.nan)
        return got

    run_all()
    torch.cuda.synchronize()
    with obs.tracing() as tracer:
        with torch.cuda.stream(_copy_stream(cuda)):
            torch.cuda._sleep(400_000_000)
        got = run_all()
        torch.cuda.synchronize()
    assert tracer.counters.get("exec.copy_stream_calls", 0) == len(cases)
    for (outs, trace), w in zip(got, want):
        _same(outs, trace, *w)


def test_staged_calls_pin_nothing_after_one_call_of_each_size(cuda):
    """Once each program has run, calls that wait for their stores, as a
    user's batches do, reuse the page-locked blocks: nothing more is
    pinned."""
    cases = _staging_cases()
    for i, (p, n, b) in enumerate(cases):
        cgra_run(p, _streams(p, n, b, seed=i), n)
    torch.cuda.synchronize()
    pinned = torch.cuda.host_memory_stats()["num_host_alloc"]
    for _ in range(3):
        for i, (p, n, b) in enumerate(cases):
            outs, _ = cgra_run(p, _streams(p, n, b, seed=i), n)
            for o in outs.values():
                o.cpu()
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == pinned


def test_staged_calls_from_threads_on_one_device(cuda):
    """Four host threads call ``cgra_run`` on one device at once, each
    staging its own streams: every call's stores equal the CPU path's."""
    cases = _staging_cases()
    want = [cgra_run(p, _streams(p, n, b, seed=i), n, device="cpu")[0]
            for i, (p, n, b) in enumerate(cases)]

    def work(t):
        got = []
        for r in range(8):
            i = (t + r) % len(cases)
            p, n, b = cases[i]
            outs, _ = cgra_run(p, _streams(p, n, b, seed=i), n)
            got.append((i, {v: o.cpu() for v, o in outs.items()}))
        return got

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(4) as pool:
            results = [f.result(timeout=120) for f in [pool.submit(work, t) for t in range(4)]]
    finally:
        sys.setswitchinterval(interval)
    for i, got in (call for res in results for call in res):
        assert all(torch.equal(got[v], want[i][v]) for v in want[i]), f"case {i}"


def test_kernel_rejects_bad_input(cuda):
    prog = _program(running_example(), (2, 2))
    tables = prog.tables.to(cuda)
    x = torch.zeros((tables.num_inputs, 3, 8), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        cgra_sim(tables, x.double())
    with pytest.raises(ValueError, match="table"):
        cgra_sim(prog.tables, x)                              # tables on the host
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
    from repro_torch.api import Compiler, resolve_options

    opts = resolve_options("deterministic-ci", space_backend="anneal")
    res = Compiler("mesh_50x50", opts).compile(load_suite(["backprop"])["backprop"])
    assert res.ok and res.space_backend == "anneal"
    prog = compile_program(res.mapping)
    num_iters, batch = 6, 300
    rng = np.random.default_rng(0)
    inputs = {v: rng.uniform(-4, 4, (num_iters, batch)).astype(np.float32)
              for v in prog.input_nodes()}
    _, trace = cgra_run(prog, inputs, num_iters)
    tables = prog.tables.to(cuda)
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


def test_daemon_solves_z3_in_worker_processes(tmp_path):
    """The daemon on ``auto`` where z3 is importable (the GPU machine's
    host): 4 workers at 20x20 send each cold z3 solve to a worker process,
    so a solve beside others takes about as long as alone (in 4 threads
    sha2 took 24.64 s against 0.08 s alone), and a repeat is a memory hit
    in the thread."""
    pytest.importorskip("z3")
    from repro_torch.core.daemon import CompileDaemon

    names = ["sha2", "fft", "gsm", "crc32", "bitcount", "aes", "basicmath", "stringsearch"]
    suite = load_suite(names)
    with CompileDaemon(CGRA(20, 20), "fast", workers=4, time_budget_s=90.0,
                       cache_dir=str(tmp_path / "cache")) as d:
        assert d._solves_in_process(d.options)
        rows = [t.wait(timeout=300) for t in [d.submit(suite[n]) for n in names]]
        again = [d.compile(suite[n]) for n in names]
    assert all(r is not None and r["ok"] and r["backend"] == "z3" for r in rows), rows
    assert max(r["wall_s"] for r in rows) < 10.0, [(r["name"], r["wall_s"]) for r in rows]
    assert all(r["source"] == "memory" for r in again)
    assert d.stats.solves == len(names) and d.stats.warm_memory == len(names)


def test_deepseek_moe_reduced_serves_on_the_card(cuda):
    """A reduced deepseek-moe-16b in bf16 on the card: one flash launch per
    layer in a prefill (head dim 32: the CUDA-core kernel), the same logits
    from two prefills, tokens in range."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), dtype=torch.bfloat16)
    spec = build_model(cfg)
    params = spec.init(0)
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, size=(2, 200))
    before = flash_attention.launches
    a = spec.prefill(params, torch.as_tensor(prompts, device="cuda"), 216)[0]
    assert flash_attention.launches == before + cfg.num_layers
    b = spec.prefill(params, torch.as_tensor(prompts, device="cuda"), 216)[0]
    assert torch.equal(a, b) and bool(torch.isfinite(a.float()).all())
    tokens = serve_batch(spec, params, prompts, 4, 216)
    assert tokens.shape == (2, 4) and ((tokens >= 0) & (tokens < cfg.vocab)).all()


def test_deepseek_v3_reduced_trains_on_the_card(cuda):
    """A reduced deepseek-v3-671b (MLA, sigmoid routing, MTP) takes a bf16
    training step on the card: finite loss, aux inside it, MTP reported."""
    cfg = dataclasses.replace(get_config("deepseek-v3-671b").reduced(), dtype=torch.bfloat16)
    spec = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=2, warmup_steps=1)
    state = train.make_state(spec, opt_cfg, 0, compression=False, device="cuda")
    batch = SyntheticLM(cfg, 2, 64, seed=0).batch_at(0, "cuda")
    _, m = train.make_step(spec, opt_cfg, compression=False)(state, batch)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert float(m["aux"]) > 0 and "mtp" in m
    assert abs(float(m["loss"]) - float(m["ce"] + m["aux"] + cfg.mtp_weight * m["mtp"])) < 1e-4


def test_hymba_reduced_serves_and_trains_on_the_card(cuda):
    """A 5-layer reduced hymba-1.5b at head dim 64 in bf16 on the card (GQA
    group 2, windows on layers 1 and 3): one tensor-core flash launch per
    layer in a prefill of meta tokens plus prompt, the same logits from two
    prefills, tokens in range, and a training step whose backward runs the
    tensor-core kernels once per layer with finite loss; in f32, the card's
    prefill and decode logits match the CPU path's within 1e-4."""
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), num_layers=5,
                              head_dim=64, dtype=torch.bfloat16)
    spec = build_model(cfg)
    params = spec.init(0)
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, size=(2, 120))
    tc = flash_attention.tensor_core_launches
    a = spec.prefill(params, torch.as_tensor(prompts, device="cuda"), 130)[0]
    assert flash_attention.tensor_core_launches == tc + cfg.num_layers
    b = spec.prefill(params, torch.as_tensor(prompts, device="cuda"), 130)[0]
    assert torch.equal(a, b) and bool(torch.isfinite(a.float()).all())
    tokens = serve_batch(spec, params, prompts, 4, 130)
    assert tokens.shape == (2, 4) and ((tokens >= 0) & (tokens < cfg.vocab)).all()
    opt_cfg = AdamWConfig(total_steps=1, warmup_steps=1)
    state = train.make_state(spec, opt_cfg, 0, compression=False, device=cuda)
    tc_bwd = flash_attention.tensor_core_backward_launches
    _, m = train.make_step(spec, opt_cfg, compression=False)(
        state, SyntheticLM(cfg, 2, 120, seed=0).batch_at(0, cuda))
    assert flash_attention.tensor_core_backward_launches - tc_bwd == cfg.num_layers
    assert bool(torch.isfinite(m["loss"]))
    spec32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    p32 = spec32.init(0, cuda)
    got, caches = spec32.prefill(p32, torch.as_tensor(prompts, device=cuda), 130)
    want, cpu_caches = spec32.prefill(_to(p32, "cpu"), torch.as_tensor(prompts), 130)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    pos = 120 + cfg.num_meta_tokens
    tok = torch.as_tensor(prompts[:, :1])
    got, _ = spec32.decode_step(p32, tok.to(cuda), caches, pos)
    want, _ = spec32.decode_step(_to(p32, "cpu"), tok, cpu_caches, pos)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_paligemma_reduced_decodes_past_its_cache_on_the_card(cuda):
    """Reduced paligemma-3b in f32 on the card: served decode runs past the
    end of the cache (positions after the 16-row image prefix) with every
    write clamped into the last slot, no device assert; prefill and decode
    logits match the CPU path's within 1e-4; a prefix-LM training step
    launches no flash kernel."""
    cfg = get_config("paligemma-3b").reduced()
    spec = build_model(cfg)
    params = spec.init(0, cuda)
    cpu = _to(params, "cpu")
    prompts = torch.as_tensor(np.random.default_rng(2).integers(1, cfg.vocab, size=(2, 40)))
    cache_len = 40 + 4 + 8
    got, caches = spec.prefill(params, prompts.to(cuda), cache_len)
    want, cpu_caches = spec.prefill(cpu, prompts, cache_len)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    base = 40 + cfg.frontend_len
    assert base + 3 >= cache_len
    for i in range(3):
        tok = prompts[:, i:i + 1]
        got, caches = spec.decode_step(params, tok.to(cuda), caches, base + i)
        want, cpu_caches = spec.decode_step(cpu, tok, cpu_caches, base + i)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(caches["dense_stack"][0].k.cpu(), cpu_caches["dense_stack"][0].k,
                               atol=1e-4, rtol=1e-4)
    tokens = serve_batch(spec, params, prompts.numpy(), 4, cache_len)
    torch.cuda.synchronize()
    assert tokens.shape == (2, 4) and ((tokens >= 0) & (tokens < cfg.vocab)).all()
    before = flash_attention.launches
    opt_cfg = AdamWConfig(total_steps=1, warmup_steps=1)
    state = train.make_state(spec, opt_cfg, 0, compression=False, device=cuda)
    _, m = train.make_step(spec, opt_cfg, compression=False)(
        state, SyntheticLM(cfg, 2, 40, seed=0).batch_at(0, cuda))
    assert flash_attention.launches == before and bool(torch.isfinite(m["loss"]))


def test_whisper_reduced_launches_the_flash_kernels_on_the_card(cuda):
    """Reduced whisper-small at head dim 64 in bf16 on the card: a prefill
    (224 tokens: padded to 256) launches the tensor-core forward once per
    decoder layer, two prefills give the same logits, a training step the
    forward twice (remat) and the tensor-core backward once per decoder
    layer with a finite loss; in f32 the card's prefill and decode logits
    match the CPU path's within 1e-4."""
    cfg = dataclasses.replace(get_config("whisper-small").reduced(), head_dim=64,
                              max_positions=256, dtype=torch.bfloat16)
    spec = build_model(cfg)
    params = spec.init(0, cuda)
    prompts = np.random.default_rng(3).integers(1, cfg.vocab, size=(2, 224))
    batch = prefill_batch(cfg, torch.as_tensor(prompts, device=cuda))
    tc = flash_attention.tensor_core_launches
    a = spec.prefill(params, batch, 240)[0]
    assert flash_attention.tensor_core_launches == tc + cfg.num_layers
    b = spec.prefill(params, batch, 240)[0]
    assert torch.equal(a, b) and bool(torch.isfinite(a.float()).all())
    tokens = serve_batch(spec, params, prompts, 4, 240)
    assert tokens.shape == (2, 4) and ((tokens >= 0) & (tokens < cfg.vocab)).all()
    opt_cfg = AdamWConfig(total_steps=1, warmup_steps=1)
    state = train.make_state(spec, opt_cfg, 0, compression=False, device=cuda)
    tc, tc_bwd = flash_attention.tensor_core_launches, flash_attention.tensor_core_backward_launches
    _, m = train.make_step(spec, opt_cfg, compression=False)(
        state, SyntheticLM(cfg, 2, 200, seed=0).batch_at(0, cuda))
    assert flash_attention.tensor_core_launches - tc == 2 * cfg.num_layers
    assert flash_attention.tensor_core_backward_launches - tc_bwd == cfg.num_layers
    assert bool(torch.isfinite(m["loss"]))
    spec32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    p32 = spec32.init(0, cuda)
    frames = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    host = {"frames": frames, "tokens": torch.as_tensor(prompts[:, :100])}
    got, caches = spec32.prefill(p32, {k: v.to(cuda) for k, v in host.items()}, 110)
    want, cpu_caches = spec32.prefill(_to(p32, "cpu"), host, 110)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    tok = torch.as_tensor(prompts[:, 100:101])
    got, _ = spec32.decode_step(p32, tok.to(cuda), caches, 100)
    want, _ = spec32.decode_step(_to(p32, "cpu"), tok, cpu_caches, 100)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_xlstm_reduced_matches_the_cpu_on_the_card(cuda):
    """Reduced xlstm-125m in f32 on the card: prefill and two decode steps
    match the CPU path within 1e-4; a training step's loss is finite."""
    cfg = get_config("xlstm-125m").reduced()
    spec = build_model(cfg)
    params = spec.init(0, cuda)
    cpu = _to(params, "cpu")
    prompts = torch.as_tensor(np.random.default_rng(1).integers(1, cfg.vocab, size=(2, 50)))
    got, states = spec.prefill(params, prompts.to(cuda), 60)
    want, cpu_states = spec.prefill(cpu, prompts, 60)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for i in range(2):
        tok = prompts[:, i:i + 1]
        got, states = spec.decode_step(params, tok.to(cuda), states, 50 + i)
        want, cpu_states = spec.decode_step(cpu, tok, cpu_states, 50 + i)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    opt_cfg = AdamWConfig(total_steps=1, warmup_steps=1)
    state = train.make_state(spec, opt_cfg, 0, compression=False, device=cuda)
    _, m = train.make_step(spec, opt_cfg, compression=False)(
        state, SyntheticLM(cfg, 2, 64, seed=0).batch_at(0, cuda))
    assert bool(torch.isfinite(m["loss"]))


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
        tables = prog.tables.to(cuda)
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
    # hymba-1.5b's prefill: GQA group 5 (25 / 5 heads), D 64, S 2048 + 128
    # meta tokens, window 1024 on 29 of its 32 layers
    ((1, 25, 5, 2176, 64), torch.bfloat16, {"window": 1024}),
    ((1, 25, 5, 2176, 64), torch.bfloat16, {}),
    ((1, 25, 5, 2176, 64), torch.float32, {"window": 1024}),
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
    return dtype != torch.float32 and d in (64, 128, 256)


# f32 within 2e-5 and bf16/f16 within 2e-2 of each gradient's max |g|
@pytest.mark.parametrize("case", [
    # the CUDA-core kernels: f32 at every D, bf16/f16 at D 96 and 192
    ((2, 4, 2, 256, 64), torch.float32, {}),
    ((1, 8, 1, 256, 96), torch.float32, {"window": 64, "softcap": 20.0}),
    ((1, 2, 2, 128, 64), torch.float32, {"causal": False}),
    ((2, 8, 4, 512, 256), torch.float32, {"window": 128, "softcap": 50.0}),
    ((1, 4, 2, 256, 96), torch.bfloat16, {}),
    ((1, 4, 2, 256, 192), torch.float16, {"window": 100}),
    # the tensor-core kernels at D 256 (dK and dV split over D): causal,
    # window 64, softcap 50 (gemma2's), GQA groups 1, 2 and 4, S below one
    # tile and ragged, non-causal, all rows masked
    ((1, 4, 2, 256, 256), torch.bfloat16, {}),
    ((1, 4, 2, 256, 256), torch.float16, {}),
    ((1, 8, 4, 384, 256), torch.bfloat16, {"window": 64}),
    ((1, 4, 2, 256, 256), torch.bfloat16, {"softcap": 50.0}),
    ((2, 8, 4, 512, 256), torch.bfloat16, {"window": 128, "softcap": 50.0}),
    ((1, 4, 4, 256, 256), torch.float16, {"window": 64, "softcap": 50.0}),
    ((1, 8, 2, 320, 256), torch.bfloat16, {}),
    ((2, 4, 2, 48, 256), torch.bfloat16, {"window": 16}),
    ((1, 4, 2, 200, 256), torch.float16, {"softcap": 50.0}),
    ((1, 2, 2, 256, 256), torch.bfloat16, {"causal": False}),
    ((1, 2, 2, 256, 256), torch.bfloat16, {"window": 0}),
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
    # hymba-1.5b's training shape: GQA group 5, D 64, window 1024
    ((1, 25, 5, 2176, 64), torch.bfloat16, {"window": 1024}),
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
    got = flash_attention_backward(q, k, v, lse, do, **opts)
    assert flash_attention.backward_launches == before + 1
    assert (flash_attention.tensor_core_backward_launches - tc_before
            == int(_tensor_core_bwd(dtype, d)))
    torch.cuda.synchronize()
    want = flash_attention_backward_torch(q, k, v, lse, do, **opts)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel_err(g, w) <= tol
    if kw.get("window") == 0:
        assert all(torch.equal(g, torch.zeros_like(g)) for g in got)


@pytest.mark.parametrize("backward", [True, False], ids=["backward", "forward"])
def test_tensor_core_kernels_run_first_in_a_fresh_thread(cuda, backward):
    """A host thread whose first CUDA work is a tensor-core kernel (as
    autograd's device thread is when the flash backward is the first node
    it runs): its TMA descriptors are encoded in a context the library
    makes current, and the result equals the main thread's."""
    import threading

    q, k, v = _qkv(1, 25, 5, 256, 64, torch.bfloat16, cuda)
    do = _qkv(1, 25, 5, 256, 64, torch.bfloat16, cuda, seed=1)[0]
    _, lse = flash_attention_lse(q, k, v, sm_scale=0.125, window=100)
    torch.cuda.synchronize()

    def run():
        if backward:
            return flash_attention_backward(q, k, v, lse, do, sm_scale=0.125, window=100)
        return (flash_attention(q, k, v, sm_scale=0.125, window=100),)

    out = {}

    def worker():
        try:
            out["got"] = run()
            torch.cuda.synchronize()
        except Exception as e:          # noqa: BLE001 - re-raised below
            out["err"] = e

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert "err" not in out, out.get("err")
    assert all(torch.equal(a, b) for a, b in zip(out["got"], run()))


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tensor_core_backward_is_deterministic(cuda, dtype, d):
    """No atomics: two launches on the same inputs give the same bits."""
    q, k, v = _qkv(2, 8, 2, 640, d, dtype, cuda, seed=3)
    do = _qkv(2, 8, 2, 640, d, dtype, cuda, seed=4)[0]
    kw = dict(sm_scale=d ** -0.5, window=300, softcap=50.0 if d == 256 else None)
    _, lse = flash_attention_lse(q, k, v, **kw)
    tc = flash_attention.tensor_core_backward_launches
    first = flash_attention_backward(q, k, v, lse, do, **kw)
    second = flash_attention_backward(q, k, v, lse, do, **kw)
    assert flash_attention.tensor_core_backward_launches - tc == 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("case", [(64, torch.bfloat16, None), (128, torch.bfloat16, None),
                                  (64, torch.float16, None), (96, torch.bfloat16, None),
                                  (256, torch.bfloat16, None), (128, torch.bfloat16, 50.0),
                                  (256, torch.bfloat16, 50.0), (256, torch.float16, 50.0)],
                         ids=["bf16-D64", "bf16-D128", "f16-D64", "bf16-D96-cuda-cores",
                              "bf16-D256", "bf16-D128-softcap", "bf16-D256-softcap",
                              "f16-D256-softcap"])
def test_flash_backward_holds_when_the_keys_share_a_mean(cuda, case):
    """Queries and keys that share a mean 32 times their spread (a deep
    decoder layer's are ~13): dq's error in the shared direction, which the
    exact dq lacks, stays out (D summed from the recomputed P dP, and on
    tensor cores the rounding errors' row sums of dS taken out, with a
    softcap as without), so every gradient is within 1e-2 of its max |g|
    of the plain version."""
    d, dtype, cap = case
    rng = np.random.default_rng(7)

    def shared(h):
        x = 0.25 * (32 * rng.standard_normal((1, h, 1, d)) + rng.standard_normal((1, h, 384, d)))
        return torch.as_tensor(x, device=cuda).to(dtype)

    q, k = shared(4), shared(2)
    v, do = (torch.as_tensor(rng.standard_normal((1, h, 384, d)), device=cuda).to(dtype)
             for h in (2, 4))
    opts = dict(sm_scale=d ** -0.5, softcap=cap)
    _, lse = flash_attention_lse(q, k, v, **opts)
    got = flash_attention_backward(q, k, v, lse, do, **opts)
    want = flash_attention_backward_torch(q, k, v, lse, do, **opts)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 1e-2


@pytest.mark.parametrize("ratio", [16.0, 32.0])
@pytest.mark.parametrize("layer", ["gemma2-27b", "gemma2-9b"])
def test_softcapped_dq_holds_at_gemma2_layer_shapes(cuda, layer, ratio):
    """A gemma2 layer's attention (softcap 50, window 4096 on a sequence
    longer than the window; gemma2-27b: D 128, 32 q / 16 kv heads, scale
    144^-0.5; gemma2-9b: D 256, 16 / 8, scale 256^-0.5) on queries and keys
    that share a mean ``ratio`` times their spread: the tensor-core dq
    within 1e-2 of its max |dq| of the plain version in f32. Before the
    epilogue took out dS's rounding errors under a softcap too, this dq kept
    their sum times the keys' mean."""
    cfg = get_config(layer)
    hq, hkv, d, s = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 4352
    rng = np.random.default_rng(11)

    def shared(h):
        x = 0.25 * (ratio * rng.standard_normal((1, h, 1, d)) + rng.standard_normal((1, h, s, d)))
        return torch.as_tensor(x, device=cuda).to(torch.bfloat16)

    q, k = shared(hq), shared(hkv)
    v, do = (torch.as_tensor(rng.standard_normal((1, h, s, d)), device=cuda).to(torch.bfloat16)
             for h in (hkv, hq))
    opts = dict(sm_scale=cfg.attn_scale, window=cfg.sliding_window, softcap=cfg.attn_softcap)
    assert (opts["softcap"], opts["window"]) == (50.0, 4096) and s > opts["window"]
    _, lse = flash_attention_lse(q, k, v, **opts)
    tc = flash_attention.tensor_core_backward_launches
    dq = flash_attention_backward(q, k, v, lse, do, **opts)[0]
    assert flash_attention.tensor_core_backward_launches - tc == 1
    f32 = [t.float() for t in (q, k, v, do)]
    _, lse32 = flash_attention_torch(*f32[:3], return_lse=True, **opts)
    want = flash_attention_backward_torch(*f32[:3], lse32, f32[3], **opts)[0]
    assert _rel_err(dq, want) <= 1e-2


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


@pytest.fixture
def nccl_mesh(cuda):
    """This process alone over NCCL, and a 1x1 ("data", "model") mesh."""
    import datetime
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        yield make_debug_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_sharded_step_on_a_one_rank_mesh_is_make_step(nccl_mesh):
    """make_sharded_step on a 1x1 NCCL mesh under the rules' shardings
    (reduced qwen3-0.6b in bf16 at head dim 64: the tensor-core kernels)
    computes what make_step computes, bit for bit, over 2 steps."""
    from repro_torch.optim import build_opt_shardings
    from repro_torch.sharding import batch_shardings, param_shardings

    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), dtype=torch.bfloat16,
                              head_dim=64)
    opt_cfg = AdamWConfig(total_steps=2, warmup_steps=1)
    data = SyntheticLM(cfg, 2, 128, seed=0)
    plain = build_model(cfg)
    state = train.make_state(plain, opt_cfg, 0, compression=False, device="cuda")
    step = train.make_step(plain, opt_cfg, compression=False)
    params = plain.init(0, "cuda")
    spec = build_model(cfg, mesh=nccl_mesh)
    p_sh = param_shardings(params, nccl_mesh, min_shard_size=4)
    o_sh = build_opt_shardings(params, p_sh, nccl_mesh)
    b_sh = batch_shardings(data.host_batch(0), nccl_mesh, ("data",))
    sh_state = train.make_sharded_state(opt_cfg, params, p_sh, o_sh, compression=False)
    sh_step = train.make_sharded_step(spec, opt_cfg, nccl_mesh, p_sh, o_sh, b_sh)
    tc = flash_attention.tensor_core_backward_launches
    for i in range(2):
        state, m = step(state, data.batch_at(i, "cuda"))
        sh_state, sm = sh_step(sh_state, data.batch_at(i, shardings=b_sh))
        assert torch.equal(m["loss"], sm["loss"]), (i, m["loss"], sm["loss"])
    assert flash_attention.tensor_core_backward_launches - tc == 4 * cfg.num_layers
    for a, b in zip(leaves(state["params"]), leaves(sh_state["params"])):
        assert torch.equal(a, b.to_local())


def test_placed_state_round_trips_on_the_card(nccl_mesh):
    """place / full_tensor / a checkpoint restored under shardings, on CUDA
    shards of the NCCL mesh."""
    import tempfile

    from repro_torch.checkpoint import restore, save
    from repro_torch.sharding import NamedSharding, P
    from repro_torch.sharding.spmd import full_tensor, place

    x = torch.randn(8, 6, device="cuda")
    sh = NamedSharding(nccl_mesh, P("data", "model"))
    d = place(x, sh)
    assert d.to_local().is_cuda and torch.equal(full_tensor(d), x)
    with tempfile.TemporaryDirectory() as ckpt:
        save(ckpt, 1, {"x": d})
        back = restore(ckpt, 1, {"x": x}, {"x": sh})
    assert torch.equal(full_tensor(back["x"]), x)


@pytest.mark.parametrize("dtype,d,window", [(torch.bfloat16, 128, None),
                                            (torch.bfloat16, 64, 96), (torch.float32, 64, None)])
def test_flash_meta_path_mirrors_the_kernel(cuda, dtype, d, window):
    """On meta tensors the forward, its log-sum-exp and the backward give
    what the kernels give on the card in shape and dtype, launch nothing,
    and report ``flash_attention_flops`` (2.5x for the backward)."""
    b, hq, hkv, s = 2, 8, 2, 256
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn((b, h, s, d), generator=g).to(cuda, dtype) for h in (hq, hkv, hkv))
    out, lse = flash_attention_lse(q, k, v, sm_scale=d ** -0.5, window=window)
    dq, dk, dv = flash_attention_backward(q, k, v, lse, out, sm_scale=d ** -0.5,
                                          window=window)
    meta = [t.to("meta") for t in (q, k, v)]
    before = (flash_attention.launches, flash_attention.backward_launches)

    def step(q, k, v):
        mo, ml = flash_attention_lse(q, k, v, sm_scale=d ** -0.5, window=window)
        return (mo, ml, *flash_attention_backward(q, k, v, ml, mo, sm_scale=d ** -0.5,
                                                  window=window))

    c = measure_step(step, *meta)
    assert (flash_attention.launches, flash_attention.backward_launches) == before
    for got, want in zip(c.result, (out, lse, dq, dk, dv)):
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    fwd = flash_attention_flops(b, hq, s, d, window=window)
    assert fwd == 4 * b * hq * d * sum(min(i + 1, window or s) for i in range(s))
    assert c.flops == fwd + flash_attention_flops(b, hq, s, d, window=window, backward=True)

