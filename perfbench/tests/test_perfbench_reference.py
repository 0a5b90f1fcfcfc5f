"""The plain reference against the port, on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import executor, reference, suite
from perfbench.inputs import StreamPool

CONFIGS = ["table3-mesh20", "table3-mesh4"]
KERNELS = suite.load_config("table3-mesh20")["kernels"]


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_equals_the_port_executor_bit_for_bit(config):
    """Every frozen mapping, lowered and run by the port's ``cgra_run`` on
    the CPU, gives the reference's stores exactly."""
    cfg = suite.load_config(config)
    dfgs, cgra = suite.port_dfgs(cfg), suite.port_cgra(cfg)
    pool = StreamPool(12345, 5, 16)

    class Ctx:
        device = "cpu"

        @staticmethod
        def span(name):
            import contextlib
            return contextlib.nullcontext()

    for k, plain in suite.plain_dfgs(cfg).items():
        m = suite.load_frozen_mapping(config, k)
        prog = executor.lower(suite.port_mapping(dfgs[k], cgra, m["ii"], m["t_abs"],
                                                 m["placement"]))
        streams = pool.streams(prog.input_nodes(), "t", k)
        stores = executor.run_batch(Ctx, prog, streams, 5)
        assert sorted(stores) == plain.stores(), k
        assert executor.store_mismatches(plain, streams, stores, 5) == 0, k


@pytest.mark.parametrize("kernel", KERNELS)
def test_reference_equals_interpret_dfg(kernel):
    """The port's scalar interpreter (``core/simulate.py::interpret_dfg``,
    Python floats) and the reference (float32) agree on integer streams."""
    from repro_torch.core.simulate import interpret_dfg

    plain = reference.PlainDFG.load(suite.dfg_path(kernel))
    dfg = suite.port_dfgs({"kernels": [kernel]})[kernel]
    rng = np.random.default_rng(7)
    streams = {v: rng.integers(-4, 5, (6, 3)).astype(np.float32) for v in plain.inputs()}
    got = reference.interpret(plain, streams, 6)
    for lane in range(3):
        want = interpret_dfg(dfg, {v: [float(x) for x in s[:, lane]] for v, s in streams.items()}, 6)
        assert sorted(want) == sorted(got)
        for v, stream in want.items():
            np.testing.assert_allclose(got[v][:, lane], np.asarray(stream, np.float32),
                                       rtol=1e-6, atol=0, equal_nan=True, err_msg=f"{kernel} {v}")


def test_bfloat16_control_fails_the_comparison():
    """The control, the reference in bfloat16, differs from the float32
    reference on the suite, and so fails a cell's ``store_mismatches``.
    fft's and stringsearch's stores are 16-bit integers of bitwise ops,
    which bfloat16 can hold exactly; the others differ."""
    pool = StreamPool(99, 8, 64)
    differ = []
    for k in KERNELS:
        plain = reference.PlainDFG.load(suite.dfg_path(k))
        streams = pool.streams(plain.inputs(), "c", k)
        low = reference.interpret(plain, streams, 8, precision="bfloat16")
        if executor.store_mismatches(plain, streams, low, 8) > 0:
            differ.append(k)
    assert len(differ) >= 14, differ


def test_to_bfloat16_matches_torch():
    x = np.random.default_rng(3).normal(0, 1e3, 4096).astype(np.float32)
    x[:4] = [np.inf, -np.inf, 0.0, -0.0]
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(reference.to_bfloat16(x), want)


def test_mismatches_counts_values_nan_and_missing_stores():
    a = {1: np.array([[1.0, np.nan]], np.float32), 2: np.zeros((1, 2), np.float32)}
    assert reference.mismatches(a, {k: v.copy() for k, v in a.items()}) == 0
    b = {1: np.array([[1.5, np.nan]], np.float32), 2: np.zeros((1, 2), np.float32)}
    assert reference.mismatches(b, a) == 1
    assert reference.mismatches({1: a[1]}, a) == 2
    assert reference.mismatches({1: a[1], 2: np.zeros((2, 2), np.float32)}, a) == 4
