"""The port's sharded serving against the JAX package's sharded serving, on
CPU ranks over gloo.

The reference runs in one subprocess per arch on 4 host devices with a
``jax.sharding.Mesh`` of ``("data", "model")`` = (2, 2) whose axes are
Auto (``jax.make_mesh`` makes Explicit axes, on which the reference's
sharded path fails; ROADMAP §3): ``build_model(cfg, mesh=mesh)``,
``param_shardings(..., min_shard_size=4)``, a prefill of 4 x 16 tokens
under ``jax.jit`` with the caches out under ``cache_shardings``, then 8
greedy decode steps with the caches in and out under them. The port runs
on 4 gloo ranks (this file run as a script, one process per rank) from the
same parameters and prompts: ``build_model(cfg, mesh=make_debug_mesh(2,
2))``, the rules' shardings, ``prefill`` and ``decode_step``.

Three cache layouts, as the reference's ``cache_shardings`` places its
stacked caches ``[L, ...]`` (dim 0 is the layers, so where the data axis
divides L it splits the layers; else a sequence of 16384 or more goes over
every axis; the batch stays whole): ``short`` (cache_len 24, the stacks
whose L the data axis divides split over it, the others whole), ``layers``
(cache_len 16384 with an even stack: layers over data, slots over model)
and ``slots`` (cache_len 16384 with odd stacks: slots over data and model).
qwen3-0.6b runs 2, 2 and 3 layers; the DeepSeek models 3, 3 and 4 (one
dense layer, then MoE layers; deepseek-v3-671b's caches are MLA latents).

Logits within 1e-4 (of max |logit|, f32) at the prefill and each decode
step, greedy tokens equal over the 8 steps, every rank's logits the same.

The families whose reference builders take no mesh (ssm, hybrid, audio)
serve on the same ranks on whole weights, each rank its rows: their
logits equal the port's unsharded run's (held to the reference by
``tests/test_torch_{hybrid,whisper}.py``) within 1e-5.
"""

import datetime
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
LOGIT_TOL = 1e-4
WHOLE_TOL = 1e-5
WHOLE_WEIGHT_ARCHS = ["xlstm-125m", "hymba-1.5b", "whisper-small"]
PROMPT, STEPS = 16, 8

#: arch -> {layout: (layers, cache_len)}
CASES = {
    "qwen3-0.6b": {"short": (2, 24), "layers": (2, 16384), "slots": (3, 16384)},
    "deepseek-moe-16b": {"short": (3, 24), "layers": (3, 16384), "slots": (4, 16384)},
    "deepseek-v3-671b": {"short": (3, 24), "layers": (3, 16384), "slots": (4, 16384)},
}

REFERENCE = textwrap.dedent("""
    import os, sys, pickle, dataclasses, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.models import build_model
    from repro.sharding import batch_shardings, cache_shardings, param_shardings

    arch, cases, out = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
    B, S, STEPS = 4, 16, 8
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    none = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    prompts = np.random.default_rng(7).integers(1, 512, size=(B, S)).astype(np.int32)
    result = {"prompts": prompts}
    for layout, (layers, cache_len) in cases.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers)
        spec = build_model(cfg, mesh=mesh, data_axes=("data",))
        params = jax.jit(spec.init)(jax.random.PRNGKey(0))
        p_sh = param_shardings(params, mesh, min_shard_size=4)
        c_sh = cache_shardings(jax.eval_shape(lambda: spec.make_caches(None, B, cache_len)),
                               mesh, ("data",))
        t_sh = batch_shardings(jax.ShapeDtypeStruct((B, 1), jnp.int32), mesh, ("data",))
        prefill = jax.jit(lambda p, t: spec.prefill(p, t, cache_len),
                          in_shardings=(p_sh, batch_shardings(prompts, mesh, ("data",))),
                          out_shardings=(None, c_sh))
        decode = jax.jit(spec.decode_step, in_shardings=(p_sh, t_sh, c_sh, none),
                         out_shardings=(None, c_sh), donate_argnums=(2,))
        params = jax.device_put(params, p_sh)
        logits, caches = prefill(params, jnp.asarray(prompts))
        seen, toks = [np.asarray(logits)], []
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        for i in range(STEPS):
            toks.append(np.asarray(tok))
            logits, caches = decode(params, tok, caches, jnp.int32(S + i))
            seen.append(np.asarray(logits))
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        result[layout] = {"params": jax.tree.map(np.asarray, params), "logits": seen,
                          "tokens": np.concatenate(toks, 1),
                          "specs": {k: [e if e is None or isinstance(e, str) else list(e)
                                        for e in v[0].spec] for k, v in c_sh.items()}}
    with open(out, "wb") as f:
        pickle.dump(result, f)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _reference(arch: str, tmp: Path) -> Path:
    out = tmp / f"reference_{arch}.pkl"
    proc = subprocess.run([sys.executable, "-c", REFERENCE, arch, json.dumps(CASES[arch]),
                           str(out)], env=_env(), cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out


def _ranks(refs: dict, tmp: Path) -> list:
    """This file as a script on 4 gloo ranks; each rank's results."""
    port = _free_port()
    procs = []
    for rank in range(4):
        spec = dict(rank=rank, world=4, port=port, refs={a: str(p) for a, p in refs.items()},
                    out=str(tmp / f"rank{rank}.pkl"))
        procs.append(subprocess.Popen([sys.executable, __file__, json.dumps(spec)],
                                      env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    errors = []
    try:
        for rank, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=TIMEOUT_S * 2)
            except subprocess.TimeoutExpired:
                errors.append(f"rank {rank}: timed out")
                continue
            if p.returncode:
                errors.append(f"rank {rank} exit {p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    out = []
    for rank in range(4):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_serve")
    with ThreadPoolExecutor(len(CASES)) as pool:
        paths = dict(zip(CASES, pool.map(lambda a: _reference(a, tmp), CASES)))
    refs = {}
    for arch, path in paths.items():
        with open(path, "rb") as f:
            refs[arch] = pickle.load(f)
    return refs, _ranks(paths, tmp)


CASE_IDS = [(a, layout) for a in CASES for layout in CASES[a]]


@pytest.mark.parametrize("arch,layout", CASE_IDS)
def test_sharded_serving_matches_the_reference_sharded_run(served, arch, layout):
    refs, ranks = served
    ref = refs[arch][layout]
    got = ranks[0][arch][layout]
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    assert len(got["logits"]) == len(ref["logits"]) == STEPS + 1
    for step, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= LOGIT_TOL, (step, err)
    for r in ranks[1:]:
        for g, w in zip(r[arch][layout]["logits"], got["logits"]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch,layout", CASE_IDS)
def test_caches_take_the_reference_placement(served, arch, layout):
    """Each stack's cache is spread over the axes of the reference's spec
    for its stacked cache (its layers' and its slots'), and rank 0 holds
    the slots that spec gives it of each layer: none of a layer the data
    axis gives to rank 2."""
    refs, ranks = served
    specs = refs[arch][layout]["specs"]
    placed = ranks[0][arch][layout]["placement"]
    _, cache_len = CASES[arch][layout]
    seq_dim = 2 if arch == "deepseek-v3-671b" else 3        # of the stacked leaf
    assert sorted(specs) == sorted(placed)

    def axes(entry):
        return [] if entry is None else [entry] if isinstance(entry, str) else entry

    for stack, (split, held) in placed.items():
        spec = specs[stack]
        assert split == axes(spec[0]) + axes(spec[seq_dim]), (stack, spec, split)
        slots = cache_len // 2 ** len(axes(spec[seq_dim]))
        layers = len(held)
        want = [slots if not axes(spec[0]) or i < layers // 2 else 0 for i in range(layers)]
        assert held == want, (stack, spec, held)


@pytest.mark.parametrize("arch", WHOLE_WEIGHT_ARCHS)
def test_whole_weight_families_serve_on_the_mesh(served, arch):
    _, ranks = served
    for r in ranks:
        got, want = r["whole"][arch]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        for g, w in zip(got["logits"], want["logits"]):
            assert np.abs(g - w).max() <= WHOLE_TOL * np.abs(w).max()


# ------------------------------------------------------------ the ranks

def _serve_case(ref: dict, arch: str, layers: int, cache_len: int, prompts) -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import param_shardings
    from repro_torch.sharding.spmd import place
    from repro_torch.tree import leaves, unflatten

    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    params = lm_params_from_numpy(ref["params"], device="cpu")
    p_sh = param_shardings(params, mesh, min_shard_size=4)
    placed = unflatten(params, [place(w, sh) for w, sh in zip(leaves(params), leaves(p_sh))])
    spec = build_model(cfg, mesh=mesh)
    with torch.no_grad():
        logits, caches = spec.prefill(placed, torch.as_tensor(prompts), cache_len)
        seen, toks = [logits.numpy().copy()], []
        tok = logits.argmax(-1)[:, None]
        for i in range(STEPS):
            toks.append(tok.numpy().copy())
            logits, caches = spec.decode_step(placed, tok, caches, PROMPT + i)
            seen.append(logits.numpy().copy())
            tok = logits.argmax(-1)[:, None]
        toks.append(tok.numpy().copy())
    placement = {name: (list(layer_caches[0].split),
                        [pc.cache[0].shape[1 if cfg.mla else 2] for pc in layer_caches])
                 for name, layer_caches in caches.items()}
    return {"logits": seen, "tokens": np.concatenate(toks, 1), "placement": placement}


def _whole_weight_case(arch: str) -> tuple:
    """(the sharded spec's, the unsharded spec's) greedy serving of one
    batch on this rank: logits and tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import decode_start, prefill_batch
    from repro_torch.models import build_model
    from repro_torch.sharding import param_shardings
    from repro_torch.sharding.spmd import place
    from repro_torch.tree import leaves, unflatten

    cfg = get_config(arch).reduced()
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    params = build_model(cfg).init(0, "cpu")
    p_sh = param_shardings(params, mesh, min_shard_size=4)
    placed = unflatten(params, [place(w, sh) for w, sh in zip(leaves(params), leaves(p_sh))])
    prompts = torch.as_tensor(np.random.default_rng(3).integers(1, cfg.vocab, (4, PROMPT)))
    out = []
    for spec, p in ((build_model(cfg, mesh=mesh), placed), (build_model(cfg), params)):
        with torch.no_grad():
            logits, caches = spec.prefill(p, prefill_batch(cfg, prompts), 32)
            seen, toks = [logits.numpy().copy()], []
            for i in range(4):
                tok = logits.argmax(-1)[:, None]
                toks.append(tok.numpy().copy())
                logits, caches = spec.decode_step(p, tok, caches,
                                                  decode_start(cfg, PROMPT) + i)
                seen.append(logits.numpy().copy())
        out.append({"logits": seen, "tokens": np.concatenate(toks, 1)})
    return tuple(out)


def _rank_main(a: dict) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{a['port']}",
                            rank=a["rank"], world_size=a["world"],
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = {}
        for arch, path in a["refs"].items():
            with open(path, "rb") as f:
                ref = pickle.load(f)
            result[arch] = {layout: _serve_case(ref[layout], arch, layers, cache_len,
                                                ref["prompts"])
                            for layout, (layers, cache_len) in CASES[arch].items()}
        result["whole"] = {arch: _whole_weight_case(arch) for arch in WHOLE_WEIGHT_ARCHS}
        with open(a["out"], "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(json.loads(sys.argv[1]))
