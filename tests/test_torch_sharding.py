"""The port's sharding rules and optimizer specs against the JAX package's.

The reference's ``param_shardings`` runs under ``jax.sharding.AbstractMesh``
on the full-size parameter shapes from ``jax.eval_shape`` (no device is
touched); the port's runs on the same shapes as meta tensors in its own
layout, where each ``*_stack`` leaf ``[L, ...]`` is a list of L per-layer
leaves. For every config and mesh, every leaf's spec equals the
reference's, a per-layer leaf's with the stack entry dropped. Also: the
rule table's cases of tests/test_substrate.py:214, ``best_mesh_shape``'s of
:178, batch, cache and ZeRO-1 moment specs, the decoder LMs' per-layer
decode caches under the reference's specs for its stacked caches, and
DTensor placements.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim import build_opt_shardings as jbuild_opt_shardings
from repro.runtime import best_mesh_shape as jbest_mesh_shape
from repro.sharding import batch_shardings as jbatch_shardings
from repro.sharding import cache_shardings as jcache_shardings
from repro.sharding import param_shardings as jparam_shardings
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.optim import build_opt_shardings
from repro_torch.runtime import best_mesh_shape
from repro_torch.sharding import (
    AbstractMesh, P, batch_shardings, cache_shardings, param_shardings, placements,
    spec_for_param,
)
from repro_torch.tree import leaves_with_paths

ARCHS = ["qwen3-0.6b", "gemma2-9b", "gemma2-27b", "mistral-nemo-12b",
         "deepseek-moe-16b", "deepseek-v3-671b", "paligemma-3b", "whisper-small",
         "xlstm-125m", "hymba-1.5b"]
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}
# (min_shard_size, force_fsdp)
OPTIONS = [(256, None), (4, None), (256, True), (4, True)]

_TORCH_DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                 jnp.dtype(jnp.float32): torch.float32,
                 jnp.dtype(jnp.int32): torch.int32}


@pytest.fixture(scope="module")
def shapes():
    """Per arch: the reference's full-size parameter shapes."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = jax.eval_shape(jbuild_model(jget_config(arch)).init,
                                         jax.random.PRNGKey(0))
        return cache[arch]

    return get


def _meta(s) -> torch.Tensor:
    return torch.empty(s.shape, dtype=_TORCH_DTYPES[jnp.dtype(s.dtype)], device="meta")


def port_layout(tree):
    """The reference's shape tree in this package's layout, as meta tensors."""
    def convert(node, layer=None):
        if isinstance(node, dict):
            return {k: convert(v, layer) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v, layer) for v in node]
        if layer is not None:
            return torch.empty(node.shape[1:], device="meta",
                               dtype=_TORCH_DTYPES[jnp.dtype(node.dtype)])
        return _meta(node)

    out = {}
    for key, node in tree.items():
        if key.endswith("_stack"):
            n = jax.tree.leaves(node)[0].shape[0]
            out[key] = [convert(node, i) for i in range(n)]
        else:
            out[key] = convert(node)
    return out


def reference_specs(tree) -> dict:
    """``{path: spec}`` of a reference tree of NamedShardings."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): tuple(s.spec)
            for kp, s in flat}


def assert_same_specs(port_tree, ref_tree, *, what=""):
    """Each port leaf's spec is the reference's; a per-layer leaf of a stack
    has the reference's spec less its (None) stack entry."""
    ref = reference_specs(ref_tree)
    seen = set()
    for path, sh in leaves_with_paths(port_tree):
        parts = path.split("/")
        stacked = len(parts) > 2 and parts[0].endswith("_stack") and parts[1].isdigit()
        key = "/".join([parts[0], *parts[2:]]) if stacked else path
        want = ref[key]
        if stacked:
            assert want[:1] in ((), (None,)), (what, key, want)
            want = want[1:]
        got = tuple(sh.spec)
        # JAX pads no spec; compare with trailing Nones dropped on both sides
        while got and got[-1] is None:
            got = got[:-1]
        while want and want[-1] is None:
            want = want[:-1]
        assert got == want, (what, path, got, want)
        seen.add(key)
    assert seen == set(ref), (what, set(ref) ^ seen)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(shapes, arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    jmesh, mesh = JAbstractMesh(sizes, names), AbstractMesh(sizes, names)
    tree = shapes(arch)
    port = port_layout(tree)
    data = tuple(a for a in names if a != "model")
    variants = [dict(min_shard_size=m, force_fsdp=f) for m, f in OPTIONS]
    variants += [dict(min_shard_size=m, expert_axes=(*data, "model")) for m in (256, 4)]
    variants += [dict(replicate_patterns=(r"^w_o$", r"^embed$"))]
    for kw in variants:
        assert_same_specs(param_shardings(port, mesh, **kw), jparam_shardings(tree, jmesh, **kw),
                          what=f"{arch} {mesh_name} {kw}")


def test_deepseek_v3_takes_the_fsdp_branch(shapes):
    """The 671B config's TP footprint per device passes the 4 GB gate, so
    its large tensors shard a free dim over the data axes, in both."""
    tree = shapes("deepseek-v3-671b")
    for sizes, names in MESHES.values():
        if sizes == (2, 2):
            continue
        port = param_shardings(port_layout(tree), AbstractMesh(sizes, names))
        data = tuple(a for a in names if a != "model")
        fsdp = [p for p, sh in leaves_with_paths(port)
                if any(e == data or e == data[0] for e in sh.spec if e is not None)]
        assert len(fsdp) > 10, (names, fsdp)
        assert_same_specs(port, jparam_shardings(tree, JAbstractMesh(sizes, names)))
    small = param_shardings(port_layout(shapes("qwen3-0.6b")), AbstractMesh((16, 16),
                                                                            ("data", "model")))
    assert not any("data" in str(sh.spec) for _, sh in leaves_with_paths(small))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moment_specs_equal_the_reference(shapes, arch, mesh_name):
    """ZeRO-1: the param spec plus 'data' on the largest free divisible dim,
    chosen on the reference's stacked shape."""
    sizes, names = MESHES[mesh_name]
    jmesh, mesh = JAbstractMesh(sizes, names), AbstractMesh(sizes, names)
    tree = shapes(arch)
    port = port_layout(tree)
    for kw in ({}, {"min_shard_size": 4}, {"force_fsdp": True}):
        ref = jbuild_opt_shardings(tree, jparam_shardings(tree, jmesh, **kw), jmesh)
        got = build_opt_shardings(port, param_shardings(port, mesh, **kw), mesh)
        for key in ("m", "v"):
            assert_same_specs(got[key], ref[key], what=f"{arch} {mesh_name} {kw} {key}")
        assert tuple(got["step"].spec) == tuple(ref["step"].spec) == ()


def test_param_sharding_rules():
    """The cases of tests/test_substrate.py:214, against JAX's specs."""
    cases = [
        (("embed", (151936, 1024)), JP("model", None)),
        (("layers/w_q", (1024, 2048)), JP(None, "model")),
        (("x/w_down", (4096, 1024)), JP("model", None)),
        (("stack/w_up", (28, 1024, 3072)), JP(None, None, "model")),
        (("moe/expert_up", (64, 2048, 1408)), JP("model", None, None)),
        (("w_k", (1024, 512)), JP(None, None)),
        (("w_if", (768, 8)), JP(None, None)),
        (("attn_norm", (1024,)), JP()),
    ]
    for (path, shape), want in cases:
        size = 13 if path == "w_k" else 16
        assert spec_for_param(path, shape, model_size=size) == want, (path, shape)
        assert tuple(spec_for_param(path, shape, model_size=size)) == tuple(want)


def test_partition_spec_entries_compare_as_jax():
    assert P("model", None) == JP("model", None)
    assert P(("data",), None) == P("data", None) == JP(("data",), None)
    assert tuple(P(("pod", "data"), "model")) == tuple(JP(("pod", "data"), "model"))
    assert P() != P(None, None)


@pytest.mark.parametrize("n, model, want", [
    (256, 16, (16, 16)), (192, 16, (12, 16)), (7, 16, (1, 7)), (3, 2, (3, 1)),
    (4, 2, (2, 2)), (12, 8, (2, 6)), (1, 4, (1, 1)), (512, 16, (32, 16)),
])
def test_elastic_mesh_shapes(n, model, want):
    """tests/test_substrate.py:178's cases and more, against the reference."""
    assert best_mesh_shape(n, model_parallel=model) == want
    assert jbest_mesh_shape(n, model_parallel=model) == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_specs_equal_the_reference(mesh_name):
    sizes, names = MESHES[mesh_name]
    jmesh, mesh = JAbstractMesh(sizes, names), AbstractMesh(sizes, names)
    data = tuple(a for a in names if a != "model")
    shapes = {"tokens": (256, 4096), "labels": (256, 4096), "frames": (256, 1500, 768),
              "odd": (3, 7), "one": (1, 16), "scalar": ()}
    jtree = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}
    ttree = {k: torch.empty(s, dtype=torch.int32, device="meta") for k, s in shapes.items()}
    for axes in (data, data[-1:]):
        got = batch_shardings(ttree, mesh, axes)
        want = jbatch_shardings(jtree, jmesh, axes)
        for k in shapes:
            assert tuple(got[k].spec) == tuple(want[k].spec), (k, axes)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cache_specs_equal_the_reference(mesh_name):
    """Cache leaves of the same shapes (batch over data; a long sequence dim
    over model, or over everything when the batch does not split)."""
    sizes, names = MESHES[mesh_name]
    jmesh, mesh = JAbstractMesh(sizes, names), AbstractMesh(sizes, names)
    data = tuple(a for a in names if a != "model")
    shapes = [(28, 256, 8, 32768, 128), (256, 8, 4096, 128), (1, 8, 524288, 128),
              (1, 16, 16384, 256), (28, 1, 8, 65536, 64), (3, 8, 100, 64), (64, 32, 576)]
    jtree = [jax.ShapeDtypeStruct(s, jnp.bfloat16) for s in shapes]
    ttree = [torch.empty(s, dtype=torch.bfloat16, device="meta") for s in shapes]
    got = cache_shardings(ttree, mesh, data)
    want = jcache_shardings(jtree, jmesh, data)
    for s, g, w in zip(shapes, got, want):
        assert tuple(g.spec) == tuple(w.spec), (s, g.spec, w.spec)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert placements(P(None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert placements(P(("pod", "data"), None), mesh) == (Shard(0), Shard(0), Replicate())
    assert placements(P(("data", "model"), None, "pod"), mesh) == (Shard(2), Shard(0),
                                                                   Shard(0))
    assert placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        placements(P(("model", "data")), mesh)      # not in the mesh's order


DECODE_CASES = [(arch, shape.name) for arch in ("qwen3-0.6b", "gemma2-9b", "deepseek-moe-16b",
                                                "deepseek-v3-671b", "paligemma-3b")
                for shape in get_config(arch).shapes() if shape.kind == "decode"]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape_name", DECODE_CASES)
def test_stacked_cache_specs_equal_the_reference(arch, shape_name, mesh_name):
    """Each layer of the port's per-layer caches carries the reference's
    spec for its stacked cache ``[L, ...]`` (dim 0 the layers), and the
    last rank's slice of it: its layers' slots where the data axes split
    the layers (none of the others), its slots of every layer where they
    split the sequence."""
    cfg = get_config(arch)
    shape = next(x for x in cfg.shapes() if x.name == shape_name)
    sizes, names = MESHES[mesh_name]
    size = dict(zip(names, sizes))
    jmesh, mesh = JAbstractMesh(sizes, names), AbstractMesh(sizes, names)
    data = tuple(a for a in names if a != "model")
    b, n = shape.global_batch, shape.seq_len
    jcaches = jax.eval_shape(lambda: jbuild_model(jget_config(arch)).make_caches(None, b, n))
    want = jcache_shardings(jcaches, jmesh, data)
    caches = build_model(cfg).make_caches({"embed": torch.empty((), device="meta")}, b, n)
    got = cache_shardings(caches, mesh, data)
    assert sorted(got) == sorted(want)
    last = {a: k - 1 for a, k in size.items()}

    def count(entry):
        out = 1
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            out *= size[a]
        return out

    for stack, layers in got.items():
        leaf = caches[stack][0][0]
        seq_dim = leaf.dim() - 2
        spec = tuple(layers[0][0].spec)
        held = leaf.shape[seq_dim] // count(spec[1 + seq_dim])
        mine = len(layers) // count(spec[0])      # the last rank's layers: the last ones
        for i, layer in enumerate(layers):
            for sh, w in zip(layer, want[stack]):
                assert (sh.layer, sh.layers) == (i, len(layers))
                assert tuple(sh.spec) == tuple(w.spec), (stack, sh.spec, w.spec)
            parts = layer[0].local_slices(tuple(leaf.shape), last)
            if i < len(layers) - mine:
                assert parts is None, (stack, i, parts)
                continue
            assert parts[seq_dim] == (leaf.shape[seq_dim] - held, held), (stack, parts)
            assert all(pt == (0, d) for k, (pt, d) in enumerate(zip(parts, leaf.shape))
                       if k != seq_dim)
