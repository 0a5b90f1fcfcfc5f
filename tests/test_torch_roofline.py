"""The port's roofline analysis (``roofline/analysis.py``) against the JAX
package's.

* ``model_flops_train``, ``model_flops_decode`` and ``active_param_count``
  are copies: equal to the reference's on every config and shape, exactly.
* ``Roofline``'s terms, bottleneck and MFU bound equal the reference's for
  the same inputs and the same ``HW`` values.
* ``record_collectives`` around the five collectives of the reference's
  HLO sample, issued through ``torch.distributed`` on a fake process group
  (world 8, the same shapes and dtypes; the collective-permute as a
  receive, the all-to-all on a group of two with two outputs), equals
  ``parse_collectives`` of the sample, kind by kind.
* ``measure_step`` counts what a small step on ``meta`` tensors does: the
  matmul FLOPs, the flash kernel's FLOPs through its meta path, every op's
  bytes, and the peak of live bytes.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.configs import all_configs as jall_configs
from repro.roofline.analysis import HW as JHW
from repro.roofline.analysis import Roofline as JRoofline
from repro.roofline.analysis import (
    active_param_count as jactive, model_flops_decode as jdecode,
    model_flops_train as jtrain, parse_collectives,
)
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_flops
from repro_torch.roofline.analysis import (
    HW, Roofline, active_param_count, measure_step, model_flops_decode, model_flops_train,
)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(jall_configs())

# the five collectives of tests/test_roofline_and_dryrun.py's HLO_SAMPLE
HLO_SAMPLE = """
HloModule test
ENTRY main {
  %p = bf16[8,128]{1,0} parameter(0)
  %ag = bf16[64,128]{1,0} all-gather(%p), replica_groups={{0,1}}, dimensions={0}
  %ar = f32[1024]{0} all-reduce(%x), to_apply=%add
  %rs = f32[128]{0} reduce-scatter(%y), dimensions={0}
  %cp = bf16[8,128]{1,0} collective-permute(%p), source_target_pairs={{0,1}}
  %a2a = (f32[16]{0}, f32[16]{0}) all-to-all(%u, %v), dimensions={0}
  %ard = f32[4]{0} all-reduce-done(%h)
}
"""

SAMPLE_COLLECTIVES = textwrap.dedent("""
    import json, warnings
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.roofline.analysis import record_collectives

    warnings.simplefilter("ignore")
    dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
    try:
        with record_collectives() as stats:
            x = torch.zeros(8, 128, dtype=torch.bfloat16)
            dist.all_gather([torch.empty_like(x) for _ in range(8)], x)
            dist.all_reduce(torch.zeros(1024))
            dist.reduce_scatter_tensor(torch.empty(128), torch.zeros(1024))
            dist.recv(torch.empty(8, 128, dtype=torch.bfloat16), src=1)
            pair = dist.new_group([0, 1])
            dist.all_to_all([torch.empty(16), torch.empty(16)],
                            [torch.zeros(16), torch.zeros(16)], group=pair)
    finally:
        dist.destroy_process_group()
    print(json.dumps([stats.bytes_by_kind, stats.count_by_kind]))
""")


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    jcfg, cfg = jall_configs()[arch], get_config(arch)
    assert active_param_count(cfg) == jactive(jcfg)
    for jshape, shape in zip(jcfg.shapes(), cfg.shapes()):
        assert shape.name == jshape.name
        assert model_flops_train(cfg, shape) == jtrain(jcfg, jshape)
        assert model_flops_decode(cfg, shape) == jdecode(jcfg, jshape)


@pytest.mark.parametrize("terms", [(197e12, 819e9, 100e9, 256),
                                   (3e15, 1e12, 1e9, 512), (1e9, 5e13, 2e12, 8)])
def test_roofline_terms_equal_the_reference(terms):
    flops, hbm, coll, chips = terms
    jhw = JHW()
    hw = HW(peak_flops=jhw.peak_flops, hbm_bw=jhw.hbm_bw, ici_bw=jhw.ici_bw)
    got = Roofline(flops=flops, hbm_bytes=hbm, collective_bytes=coll, chips=chips, hw=hw)
    want = JRoofline(flops=flops, hbm_bytes=hbm, collective_bytes=coll, chips=chips, hw=jhw)
    for name in ("t_compute", "t_memory", "t_collective", "bottleneck", "bound_time"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.mfu_upper_bound(1e17) == want.mfu_upper_bound(1e17)


def test_hw_is_one_h100():
    assert (HW().peak_flops, HW().hbm_bw, HW().ici_bw) == (989e12, 3.35e12, 50e9)


def test_record_collectives_equals_parse_collectives():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", SAMPLE_COLLECTIVES], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got_bytes, got_counts = json.loads(proc.stdout.strip().splitlines()[-1])
    want = parse_collectives(HLO_SAMPLE)
    assert got_bytes == want.bytes_by_kind
    assert got_counts == want.count_by_kind


def test_measure_step_counts_a_meta_step():
    """Two matmuls and a flash forward on meta tensors: the FLOPs of the
    products and of the kernel's meta path, bytes of every op, and the
    peak of the live bytes (arguments, then the step's temporaries)."""
    b, h, s, d = 2, 4, 256, 64
    x = torch.empty((b * s, 512), device="meta")
    w = torch.empty((512, 3 * h * d), device="meta")

    def step(x, w):
        qkv = (x @ w).reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
        out = flash_attention(qkv[0].contiguous(), qkv[1].contiguous(), qkv[2].contiguous())
        return out.sum()

    c = measure_step(step, x, w)
    mm = 2 * (b * s) * 512 * (3 * h * d)
    assert c.flops == mm + flash_attention_flops(b, h, s, d)
    assert c.arg_bytes == (x.numel() + w.numel()) * 4
    # x @ w is alive while the three contiguous copies are made
    assert c.peak_bytes >= c.arg_bytes + 2 * (b * s * 3 * h * d * 4)
    assert c.hbm_bytes > (x.numel() + w.numel() + b * s * 3 * h * d) * 4
    assert c.collectives.total_bytes == 0 and c.out_bytes == 4


def test_flash_flops_match_the_bound_formula():
    """``flash_attention_flops``: 4 B Hq D over the pairs the masks leave;
    the backward 2.5x."""
    assert flash_attention_flops(4, 16, 2048, 128) == 4 * 4 * 16 * 128 * 2048 * 2049 // 2
    assert flash_attention_flops(1, 2, 8, 32, window=3) == 4 * 2 * 32 * (6 + 5 * 3)
    assert flash_attention_flops(1, 2, 8, 32, causal=False) == 4 * 2 * 32 * 64
    assert flash_attention_flops(4, 16, 2048, 128, backward=True) == \
        flash_attention_flops(4, 16, 2048, 128) * 5 // 2
