"""The port's sharded training against the JAX package's sharded run, on
CPU ranks over gloo.

Each case runs the reference in a subprocess on 4 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) with a
``jax.sharding.Mesh`` of ``("data", "model")`` = (2, 2) (``jax.make_mesh``
makes Explicit axes, on which the reference's sharded path fails; see
ROADMAP §3): ``build_model(cfg, mesh=mesh)``, ``param_shardings(...,
min_shard_size=4)``, ``build_opt_shardings`` and ``batch_shardings`` under
``jax.jit(in_shardings=...)``, one value-and-grad and one AdamW update of
the ``reduced()`` config in f32. The port then runs on 4 gloo ranks (this
file run as a script, one process per rank, each with its own free port
and a 120 s timeout on the process group and on the join), from the same
parameters and batch: ``build_model(cfg, mesh=make_debug_mesh(2, 2))``,
its rules' shardings, ``sharded_grads`` and ``make_sharded_step``.

Tolerances, as the port's reduced-training tests (``test_torch_train.py``):
loss 1e-5; each gradient leaf 1e-4 of its max |g|; AdamW fed the
reference's gradients 1e-6. The whole step's parameters are held within
2 lr + 1e-6: AdamW's first step moves each parameter by about lr
sign(g), and gradients that agree to 1e-4 of max |g| can still differ in
sign near zero; so each leaf's update is also held against the
reference's in norm, ||d - d_ref|| / ||d_ref|| within 1e-2, which a leaf
left unchanged (1) or updated from a wrong gradient fails.

deepseek-moe-16b's sharded loss differs from its unsharded loss, as the
reference's does: its aux loss is averaged over the data shards' own
routing, and with a capacity factor of 1.0 (the ``drops`` case) each data
shard's capacity comes from its own tokens, so the two runs drop different
assignments. Computing either over the global batch fails these cases.

Also here: ``compressed_psum_mean`` over the pod axis of a (pod 2 x data 2)
mesh against the reference's own ``compress``/``decompress``, with int8
on the all-gather; a checkpoint saved on a 2x2 mesh restored bit for bit on
3 ranks after ``remesh``; the fault runner's restart on placed state.
"""

import datetime
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jcompress
from repro.optim import decompress as jdecompress

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-6
# each leaf's whole-step update against the reference's, in norm:
# ||d - d_ref|| / ||d_ref|| (d = new - initial parameters); an unchanged
# leaf reads 1. Measured at most 7.3e-4 over the five cases (xlstm-125m's
# sLSTM bias; 1.2e-4 or less for qwen3-0.6b and gemma2-9b).
UPDATE_NORM_TOL = 1e-2

REFERENCE = textwrap.dedent("""
    import os, sys, pickle, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.configs import get_config
    from repro.data import SyntheticLM
    from repro.models import build_model
    from repro.optim import (
        AdamWConfig, adamw_init, adamw_update, build_opt_shardings,
        compress_grads_with_feedback, init_residual,
    )
    from repro.sharding import batch_shardings, param_shardings

    arch, capacity, out = sys.argv[1], float(sys.argv[2]), sys.argv[3]
    cfg = get_config(arch).reduced()
    if capacity:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    spec = build_model(cfg, mesh=mesh, data_axes=("data",))
    params = jax.jit(spec.init)(jax.random.PRNGKey(0))
    p_sh = param_shardings(params, mesh, min_shard_size=4)
    opt_cfg = AdamWConfig()
    opt = adamw_init(params, opt_cfg)
    o_sh = build_opt_shardings(params, p_sh, mesh)
    batch = SyntheticLM(cfg, 4, 64, seed=0).host_batch(0)
    b_sh = batch_shardings(batch, mesh, ("data",))

    def train_step(params, opt, batch):
        (loss, m), g = jax.value_and_grad(spec.loss_fn, has_aux=True)(params, batch)
        p2, o2, om = adamw_update(g, opt, params, opt_cfg)
        return p2, loss, m, g, om

    p2, loss, m, g, om = jax.jit(train_step, in_shardings=(p_sh, o_sh, b_sh))(
        jax.device_put(params, p_sh), jax.device_put(opt, o_sh),
        jax.device_put(batch, b_sh))
    unsharded = build_model(cfg).loss_fn(params, batch)[0]
    host = lambda t: jax.tree.map(np.asarray, t)
    result = {"params": host(params), "batch": batch, "loss": float(loss),
              "metrics": {k: float(v) for k, v in m.items()}, "grads": host(g),
              "new_params": host(p2), "grad_norm": float(om["grad_norm"]),
              "lr": float(om["lr"]), "unsharded_loss": float(unsharded)}
    if arch == "qwen3-0.6b":
        # the step with gradient compression (error feedback from zero)
        def compressed_step(params, opt, batch):
            g = jax.grad(lambda p: spec.loss_fn(p, batch)[0])(params)
            g, _ = compress_grads_with_feedback(g, init_residual(params))
            return adamw_update(g, opt, params, opt_cfg)[0]

        result["compressed_new_params"] = host(jax.jit(
            compressed_step, in_shardings=(p_sh, o_sh, b_sh))(
            jax.device_put(params, p_sh), jax.device_put(opt, o_sh),
            jax.device_put(batch, b_sh)))
    with open(out, "wb") as f:
        pickle.dump(result, f)
""")

# (arch, capacity factor: 0 keeps the reduced config's)
CASES = {
    "qwen3-0.6b": ("qwen3-0.6b", 0.0),
    "gemma2-9b": ("gemma2-9b", 0.0),
    "deepseek-moe-16b": ("deepseek-moe-16b", 0.0),
    "deepseek-moe-16b-drops": ("deepseek-moe-16b", 1.0),
    "xlstm-125m": ("xlstm-125m", 0.0),    # a family the rules shard, run on whole weights
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def run_ranks(job: str, world: int, args: dict, tmp: Path) -> list:
    """This file as a script on ``world`` gloo ranks running ``job``; each
    rank's result, unpickled. Raises if a rank fails or outlives the
    timeout (every rank is killed then)."""
    port = _free_port()
    procs = []
    for rank in range(world):
        spec = dict(args, job=job, rank=rank, world=world, port=port,
                    out=str(tmp / f"{job}_rank{rank}.pkl"))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, json.dumps(spec)], env=_env(), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
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
    for rank in range(world):
        with open(tmp / f"{job}_rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Per case: the reference's sharded run and the port's on 4 ranks."""
    cache = {}

    def get(case: str):
        if case not in cache:
            arch, capacity = CASES[case]
            tmp = tmp_path_factory.mktemp(case)
            ref_path = tmp / "reference.pkl"
            proc = subprocess.run(
                [sys.executable, "-c", REFERENCE, arch, str(capacity), str(ref_path)],
                env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=600)
            assert proc.returncode == 0, proc.stderr[-3000:]
            got = run_ranks("parity", 4, {"arch": arch, "capacity": capacity,
                                          "reference": str(ref_path)}, tmp)
            with open(ref_path, "rb") as f:
                cache[case] = pickle.load(f), got
        return cache[case]

    return get


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_loss_matches_the_reference_sharded_run(parity, case):
    ref, ranks = parity(case)
    for r in ranks:       # every rank reports the global loss
        assert abs(r["loss"] - ref["loss"]) <= LOSS_TOL * max(1.0, abs(ref["loss"])), (
            r["loss"], ref["loss"])
        for k, v in ref["metrics"].items():
            assert abs(r["metrics"][k] - v) <= LOSS_TOL * max(1.0, abs(v)), (k, r, ref)
        assert abs(r["grad_norm"] - ref["grad_norm"]) <= 1e-4 * ref["grad_norm"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_gradients_match_the_reference_sharded_run(parity, case):
    ref, ranks = parity(case)
    want = dict(_leaves(ref["grads"]))
    got = dict(_leaves(ranks[0]["grads"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        err = np.abs(got[path] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (path, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_update_matches_the_reference_sharded_run(parity, case):
    """AdamW on the placed state (ZeRO-1 moments) fed the reference's
    gradients gives its parameters within 1e-6; the whole step within
    2 lr + 1e-6, and each leaf's update within 1e-2 of the reference's in
    norm."""
    ref, ranks = parity(case)
    want = dict(_leaves(ref["new_params"]))
    for key, tol in (("update_from_reference_grads", UPDATE_TOL),
                     ("new_params", 2 * ref["lr"] + UPDATE_TOL)):
        got = dict(_leaves(ranks[0][key]))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            err = np.abs(got[path] - w).max()
            assert err <= tol, (key, path, err, tol)
    start, got = dict(_leaves(ref["params"])), dict(_leaves(ranks[0]["new_params"]))
    for path, w in want.items():
        d_ref = w - start[path]
        off = np.linalg.norm(got[path] - w) / np.linalg.norm(d_ref)
        assert off <= UPDATE_NORM_TOL, (path, off)


def test_deepseek_sharded_loss_is_not_the_unsharded_loss(parity):
    """The aux loss averaged over data shards, and capacity from each data
    shard's tokens, make the sharded loss differ from the unsharded one,
    in the reference and in the port alike."""
    for case in ("deepseek-moe-16b", "deepseek-moe-16b-drops"):
        ref, ranks = parity(case)
        gap = abs(ref["loss"] - ref["unsharded_loss"])
        assert gap > 20 * LOSS_TOL, (case, ref["loss"], ref["unsharded_loss"])
        assert abs(ranks[0]["loss"] - ref["unsharded_loss"]) > 10 * LOSS_TOL
        assert abs(ranks[0]["unsharded_loss"] - ref["unsharded_loss"]) <= LOSS_TOL
    ref, _ = parity("deepseek-moe-16b-drops")
    assert abs(ref["loss"] - ref["unsharded_loss"]) > 1e-3     # drops differ


def test_sharded_update_with_compression_matches_the_reference(parity):
    """The sharded update with compression, fed the reference's gradients:
    each whole gradient quantised in 256-blocks, as the reference's step
    quantises its global gradient, so the parameters equal the reference's
    compressed step within 1e-6 (quantising each rank's shard in its own
    blocks moves some by lr); and they differ from the uncompressed update."""
    ref, ranks = parity("qwen3-0.6b")
    want = dict(_leaves(ref["compressed_new_params"]))
    got = dict(_leaves(ranks[0]["compressed_new_params"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert np.abs(got[path] - w).max() <= UPDATE_TOL, path
    plain = dict(_leaves(ranks[0]["update_from_reference_grads"]))
    assert any(not np.array_equal(plain[p], got[p]) for p in got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_state_follows_the_rules(parity, case):
    """Every placed leaf carries the rules' placements (ZeRO-1 moments the
    data axis on top), and each rank's shard is the right slice."""
    _, ranks = parity(case)
    for r in ranks:
        assert r["placement_errors"] == [], r["placement_errors"]
    assert any(r["moment_sharded_leaves"] for r in ranks)


def test_compression_quantises_a_stack_as_the_reference():
    """compress_grads_with_feedback on per-layer leaves of a stack equals the
    reference's on the stacked leaf, over steps: the 256-blocks run across
    layers where a layer's leaf (a [128] norm here) is not a multiple of
    256."""
    from repro.optim import compress_grads_with_feedback as jfeedback
    from repro_torch.optim import compress_grads_with_feedback, init_residual

    rng = np.random.default_rng(3)
    stacked = {"dense_stack": {"attn_norm": rng.standard_normal((3, 128)).astype(np.float32),
                               "w": rng.standard_normal((3, 7, 60)).astype(np.float32)},
               "embed": rng.standard_normal((50, 9)).astype(np.float32)}
    port = {"dense_stack": [{k: torch.from_numpy(v[i].copy())
                             for k, v in stacked["dense_stack"].items()} for i in range(3)],
            "embed": torch.from_numpy(stacked["embed"])}
    jg = jax.tree.map(jnp.asarray, stacked)
    jr = jax.tree.map(jnp.zeros_like, jg)
    r = init_residual(port)
    for _ in range(3):
        out, r = compress_grads_with_feedback(port, r)
        jout, jr = jfeedback(jg, jr)
        for name in ("attn_norm", "w"):
            got = np.stack([layer[name].numpy() for layer in out["dense_stack"]])
            np.testing.assert_array_equal(got, np.asarray(jout["dense_stack"][name]))
            res = np.stack([layer[name].numpy() for layer in r["dense_stack"]])
            np.testing.assert_array_equal(res, np.asarray(jr["dense_stack"][name]))
        np.testing.assert_array_equal(out["embed"].numpy(), np.asarray(jout["embed"]))


def test_compressed_psum_mean_over_the_pod_axis(tmp_path):
    """On a (pod 2 x data 2) mesh: the int8 payload crosses the all-gather,
    the result is the mean of the reference's dequantised payloads of the
    pod's two ranks (1e-6) and within 0.05 of the exact mean."""
    ranks = run_ranks("compress", 4, {}, tmp_path)
    xs = {r: _pod_input(r) for r in range(4)}
    for r in ranks:
        pod_peers = [p for p in range(4) if p % 2 == r["rank"] % 2]
        deq = [np.asarray(jdecompress(*jcompress(xs[p]), xs[p].shape)) for p in pod_peers]
        np.testing.assert_allclose(r["mean"], np.mean(deq, axis=0), atol=1e-6, rtol=0)
        exact = np.mean([xs[p] for p in pod_peers], axis=0)
        assert np.abs(r["mean"] - exact).max() <= 0.05
        assert "torch.int8" in r["wire_dtypes"], r["wire_dtypes"]


def test_checkpoint_restores_bit_for_bit_on_a_remeshed_world(tmp_path):
    """Saved from a 2x2 mesh, restored on 3 ranks (best_mesh_shape(3, 2) =
    (3, 1)) under reshard_state's shardings: every leaf bit-equal."""
    ckpt = tmp_path / "ckpt"
    saved = run_ranks("ckpt_save", 4, {"ckpt": str(ckpt)}, tmp_path)
    restored = run_ranks("ckpt_restore", 3, {"ckpt": str(ckpt)}, tmp_path)
    want = saved[0]["state"]
    for r in restored:
        assert r["mesh"] == [3, 1]
        assert sorted(r["state"]) == sorted(want)
        for path, w in want.items():
            assert r["state"][path].dtype == w.dtype, path
            assert np.array_equal(r["state"][path], w), path
        assert r["local_rows_match"]


def test_fault_runner_restarts_on_placed_state(tmp_path):
    """run_training with a failure injected on 4 ranks: it restores the
    placed checkpoint with the given shardings and ends where an
    uninterrupted run ends, bit for bit."""
    ranks = run_ranks("fault", 4, {"ckpt": str(tmp_path / "ckpt")}, tmp_path)
    for r in ranks:
        assert r["restarts"] == 1
        assert r["equal"], r


# ------------------------------------------------------------ the ranks

def _pod_input(rank: int) -> np.ndarray:
    return np.random.default_rng(100 + rank).standard_normal((3, 700)).astype(np.float32)


def _rank_parity(a: dict) -> dict:
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.interop import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (
        make_sharded_state, make_sharded_step, sharded_grads, sharded_update,
    )
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, build_opt_shardings
    from repro_torch.sharding import batch_shardings, param_shardings, placements
    from repro_torch.sharding.spmd import Spmd, full_tensor, place
    from repro_torch.tree import leaves, leaves_with_paths, unflatten

    with open(a["reference"], "rb") as f:
        ref = pickle.load(f)
    cfg = get_config(a["arch"]).reduced()
    if a["capacity"]:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=a["capacity"]))
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    spmd = Spmd(mesh)
    params = lm_params_from_numpy(ref["params"], device="cpu")
    spec = build_model(cfg, mesh=mesh)
    p_sh = param_shardings(params, mesh, min_shard_size=4)
    o_sh = build_opt_shardings(params, p_sh, mesh)
    host = {k: np.asarray(v) for k, v in ref["batch"].items()}
    b_sh = batch_shardings(host, mesh, ("data",))
    opt_cfg = AdamWConfig()
    state = make_sharded_state(opt_cfg, params, p_sh, o_sh, compression=False)
    batch = {k: place(torch.as_tensor(v), b_sh[k]) for k, v in host.items()}

    # the placed state carries the rules' placements and the right slices
    errors, moment_sharded = [], 0
    for (path, d), sh, full in zip(leaves_with_paths(state["params"]), leaves(p_sh),
                                   leaves(params)):
        if tuple(d.placements) != placements(sh.spec, mesh):
            errors.append(f"{path}: {d.placements} != {sh.spec}")
        if not torch.equal(full_tensor(d), full):
            errors.append(f"{path}: gathered shard differs")
    for d, sh, psh in zip(leaves(state["opt"]["m"]), leaves(o_sh["m"]), leaves(p_sh)):
        if tuple(d.placements) != placements(sh.spec, mesh):
            errors.append(f"moment {sh.spec}: {d.placements}")
        moment_sharded += "data" in {x for e in sh.spec if e for x in
                                     (e if isinstance(e, tuple) else (e,))}

    loss, metrics, grads = sharded_grads(spec, state["params"], batch, spmd)
    whole = [reshard_whole(g, d, spmd) for g, d in zip(grads, leaves(state["params"]))]
    new_state, m = make_sharded_step(spec, opt_cfg, mesh, p_sh, o_sh, b_sh)(state, batch)

    # the update on the placed state (ZeRO-1), fed the reference's gradients
    ref_g = [place(g, sh).to_local() for g, sh in
             zip(leaves(lm_params_from_numpy(ref["grads"], device="cpu")), leaves(p_sh))]
    upd = sharded_update(state, ref_g, opt_cfg, spmd, compression=False)[0]["params"]
    compressed = None
    if "compressed_new_params" in ref:
        c_state = make_sharded_state(opt_cfg, params, p_sh, o_sh, compression=True)
        compressed = sharded_update(c_state, ref_g, opt_cfg, spmd,
                                    compression=True)[0]["params"]

    unsharded = build_model(cfg).loss_fn(params, {k: torch.as_tensor(v)
                                                  for k, v in host.items()})[0]
    full = lambda tree: lm_params_to_numpy(unflatten(params, [  # noqa: E731
        full_tensor(d) for d in leaves(tree)]))
    assert isinstance(leaves(new_state["params"])[0], DTensor)
    dist.barrier()
    return {"loss": float(m["loss"]), "local_loss": float(loss),
            "metrics": {k: float(v) for k, v in m.items()
                        if k not in ("loss", "grad_norm", "lr")},
            "grad_norm": float(m["grad_norm"]),
            "grads": lm_params_to_numpy(unflatten(params, whole)),
            "new_params": full(new_state["params"]),
            "update_from_reference_grads": full(upd),
            "compressed_new_params": compressed and full(compressed),
            "unsharded_loss": float(unsharded),
            "placement_errors": errors, "moment_sharded_leaves": moment_sharded}


def reshard_whole(g, d, spmd):
    from repro_torch.sharding.spmd import reshard, spec_of

    return reshard(g, spec_of(d), (), spmd)


def _rank_compress(a: dict) -> dict:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import compressed_psum_mean

    mesh = make_mesh((2, 2), ("pod", "data"), device_type="cpu")
    seen = []
    gather = dist.all_gather

    def recording(parts, t, *args, **kw):
        seen.append(str(t.dtype))
        return gather(parts, t, *args, **kw)

    dist.all_gather = recording
    try:
        mean = compressed_psum_mean(torch.from_numpy(_pod_input(a["rank"])), "pod", mesh)
    finally:
        dist.all_gather = gather
    return {"rank": a["rank"], "mean": mean.numpy(), "wire_dtypes": seen}


def _small_state(mesh, min_shard_size=4):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_sharded_state
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, build_opt_shardings
    from repro_torch.sharding import param_shardings

    cfg = get_config("qwen3-0.6b").reduced()
    params = build_model(cfg).init(0, "cpu")
    p_sh = param_shardings(params, mesh, min_shard_size=min_shard_size)
    o_sh = build_opt_shardings(params, p_sh, mesh)
    spec = build_model(cfg, mesh=mesh)
    state = make_sharded_state(AdamWConfig(), params, p_sh, o_sh, compression=False)
    return cfg, spec, params, p_sh, o_sh, state


def _host_state(state) -> dict:
    from repro_torch.sharding.spmd import full_tensor
    from repro_torch.tree import leaves_with_paths

    return {p: full_tensor(d).numpy().copy() for p, d in leaves_with_paths(state)}


def _rank_ckpt_save(a: dict) -> dict:
    from repro_torch.checkpoint import save
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(2, 2, device_type="cpu")
    *_, state = _small_state(mesh)
    save(a["ckpt"], 1, state)
    return {"state": _host_state(state)}


def _rank_ckpt_restore(a: dict) -> dict:
    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import remesh, reshard_state
    from repro_torch.sharding import batch_shardings

    mesh = remesh(list(range(a["world"])), model_parallel=2, device_type="cpu")
    cfg = get_config("qwen3-0.6b").reduced()
    params = build_model(cfg).init(1, "cpu")       # another seed: only the layout counts
    like = {"params": params, "opt": adamw_init(params, AdamWConfig())}
    state = restore(a["ckpt"], 1, like, reshard_state(like, mesh))
    data = SyntheticLM(cfg, 3, 8, seed=0)
    host = data.host_batch(0)
    b = data.batch_at(0, shardings=batch_shardings(host, mesh, ("data",)))
    rows = b["tokens"].to_local().numpy()
    ok = np.array_equal(rows, host["tokens"][a["rank"]:a["rank"] + 1])
    return {"state": _host_state(state), "mesh": list(mesh.mesh.shape),
            "local_rows_match": ok}


def _rank_fault(a: dict) -> dict:
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import make_sharded_step
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import FaultConfig, run_training
    from repro_torch.sharding import batch_shardings

    mesh = make_debug_mesh(2, 2, device_type="cpu")
    cfg, spec, params, p_sh, o_sh, state = _small_state(mesh)
    data = SyntheticLM(cfg, 4, 16, seed=0)
    b_sh = batch_shardings(data.host_batch(0), mesh, ("data",))
    step = make_sharded_step(spec, AdamWConfig(), mesh, p_sh, o_sh, b_sh)
    batch_fn = lambda s: data.batch_at(s, shardings=b_sh)  # noqa: E731
    plain, _ = run_training(step, state, batch_fn, 4,
                            FaultConfig(ckpt_dir=a["ckpt"] + "_plain", ckpt_every=2))
    boom = {"armed": True}

    def injector(s):
        if s == 3 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    shardings = {"params": p_sh, "opt": o_sh}
    got, report = run_training(step, state, batch_fn, 4,
                               FaultConfig(ckpt_dir=a["ckpt"], ckpt_every=2),
                               shardings=shardings, fail_injector=injector)
    want, have = _host_state(plain), _host_state(got)
    equal = sorted(want) == sorted(have) and all(np.array_equal(want[k], have[k])
                                                 for k in want)
    return {"restarts": report.restarts, "equal": equal}


def _rank_main(a: dict) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{a['port']}",
                            rank=a["rank"], world_size=a["world"],
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        job = {"parity": _rank_parity, "compress": _rank_compress,
               "ckpt_save": _rank_ckpt_save, "ckpt_restore": _rank_ckpt_restore,
               "fault": _rank_fault}[a["job"]]
        result = job(a)
        with open(a["out"], "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(json.loads(sys.argv[1]))
