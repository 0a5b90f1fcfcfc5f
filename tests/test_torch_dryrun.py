"""The port's dry-run (``launch/dryrun.py``) on fake process groups.

The reference's mini dry-run archs (qwen3-0.6b, deepseek-moe-16b,
gemma2-9b, ``.reduced()``) at train_4k, prefill_32k and decode_32k on a
2x2x2 ("pod", "data", "model") fake mesh and on a 1x1x1 one, and
qwen3-0.6b's train_4k at full size on the production 16x16 mesh, each
through ``run_cell`` in one subprocess (the fake process group is global
state; ``run_cell`` destroys it after each cell). Checks:

* every cell is ``ok`` with positive FLOPs;
* rank 0's parameter bytes equal the sum of the reference's
  ``param_shardings`` shard bytes under ``jax.sharding.AbstractMesh``;
* FLOP conservation: 8 x rank 0's FLOPs on 2x2x2 equal the 1-rank FLOPs,
  exactly for the dense archs. The one exception is MoE's router: its
  ``[tokens, d] @ [d, experts]`` product runs on every rank of the model
  axis, as in the reference's island (its ``router`` enters replicated),
  so deepseek-moe-16b's 8 x per-rank FLOPs exceed the 1-rank FLOPs by
  exactly one more copy of the router's products (forward, the remat
  recompute and the two gradient products of a training step; the forward
  of a serving pass).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.sharding import param_shardings as jparam_shardings

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-0.6b", "deepseek-moe-16b", "gemma2-9b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
MESHES = [(2, 2, 2), (1, 1, 1)]

CELLS = textwrap.dedent("""
    import contextlib, io, sys
    from repro_torch.launch.dryrun import run_cell
    results, cells = sys.argv[1], sys.argv[2:]
    for cell in cells:
        arch, shape, mesh, reduced = cell.split(",")
        with contextlib.redirect_stdout(io.StringIO()):
            run_cell(arch, shape, False, results,
                     mesh_shape=tuple(int(x) for x in mesh.split("x")),
                     reduced=reduced == "1")
""")


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """``{(arch, shape, mesh name): result}`` of every cell."""
    out = tmp_path_factory.mktemp("dryrun")
    mini = [f"{a},{s},{'x'.join(map(str, m))},1" for a in ARCHS for s in SHAPES
            for m in MESHES]
    procs = [subprocess.Popen([sys.executable, "-c", CELLS, str(out), *group],
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for group in (mini, ["qwen3-0.6b,train_4k,16x16,0"])]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    results = {}
    for f in out.iterdir():
        r = json.loads(f.read_text())
        results[(r["arch"], r["shape"], r["mesh"])] = r
    return results


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cells_run(cells, arch, shape):
    for mesh in ("2x2x2", "1x1x1"):
        r = cells[(arch, shape, mesh)]
        assert r["ok"] and r["hlo_flops_per_dev"] > 0, r
        assert r["cost_method"] == "direct (every layer run)"
        assert r["chips"] == (8 if mesh == "2x2x2" else 1)
        assert r["peak_bytes_per_dev"] >= r["arg_bytes_per_dev"] > 0
        assert r["bottleneck"] in ("compute", "memory", "collective")
    # the 1-rank run has no collective to make
    assert cells[(arch, shape, "1x1x1")]["collective_bytes_per_dev"] == 0
    assert cells[(arch, shape, "2x2x2")]["collective_bytes_per_dev"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_equal_the_reference_shards(cells, arch):
    """Rank 0's placed parameters hold the bytes of the reference's shards
    under the same rules on the same (abstract) mesh."""
    params = jax.eval_shape(jbuild_model(jget_config(arch).reduced()).init,
                            jax.random.PRNGKey(0))
    mesh = JAbstractMesh((2, 2, 2), ("pod", "data", "model"))
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    want = 0
    for leaf, sh in zip(jax.tree.leaves(params), jax.tree.leaves(jparam_shardings(params, mesh))):
        n = int(np.prod(leaf.shape))
        for entry in sh.spec:
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                n //= sizes[a]
        want += n * leaf.dtype.itemsize
    for shape in SHAPES:
        assert cells[(arch, shape, "2x2x2")]["param_bytes_per_dev"] == want


def _router_flops(arch: str, shape: str) -> int:
    """FLOPs of one rank's copy of the router's products over a step."""
    cfg = jget_config(arch).reduced()
    s = next(x for x in cfg.shapes() if x.name == shape)
    tokens = s.global_batch * (1 if s.kind == "decode" else s.seq_len)
    passes = (4 if cfg.remat else 3) if s.kind == "train" else 1
    n_moe = cfg.num_layers - cfg.num_dense_layers
    return passes * 2 * tokens * cfg.d_model * cfg.moe.num_experts * n_moe


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_are_conserved_over_the_mesh(cells, arch, shape):
    per_rank = cells[(arch, shape, "2x2x2")]["hlo_flops_per_dev"]
    one = cells[(arch, shape, "1x1x1")]["hlo_flops_per_dev"]
    extra = _router_flops(arch, shape) if jget_config(arch).moe else 0
    assert 8 * per_rank == one + (2 - 1) * extra, (8 * per_rank, one, extra)


def test_full_size_cell_on_the_production_mesh(cells):
    r = cells[("qwen3-0.6b", "train_4k", "16x16")]
    assert r["ok"] and r["chips"] == 256 and r["hlo_flops_per_dev"] > 0
    assert 0 < r["useful_flops_ratio"] <= 1
    assert 0 < r["mfu_upper_bound"] <= 1
    assert r["collectives"]["all-reduce"] > 0
    assert r["t_compute"] == pytest.approx(r["hlo_flops_per_dev"] / 989e12)
