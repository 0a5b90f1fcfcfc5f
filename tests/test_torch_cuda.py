"""The CUDA kernel against its plain PyTorch version, on a GPU.

Needs a CUDA GPU and the CUDA toolkit; skipped elsewhere. Run on the card
with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.
Imports nothing of JAX, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import CGRA, map_dfg, running_example
from repro_torch.core.benchsuite import load_suite
from repro_torch.kernels.cgra_sim import cgra_sim, cgra_sim_torch
from repro_torch.kernels.ops import cgra_run, compile_program
from repro_torch.kernels.ref import cgra_sim_reference

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
