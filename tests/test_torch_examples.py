"""The port's example twins run end to end on the CPU (``--device cpu``):
``examples/serve_lm_torch.py`` serves its reduced model, and
``examples/train_lm_torch.py`` trains one until its loss decreases (the
example asserts it). ``examples/compile_suite_torch.py`` maps the whole
suite, minutes on a CPU host, and is left to a manual run."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script), *args],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-moe-16b"])
def test_serve_example_runs_on_the_cpu(arch):
    out = _run("serve_lm_torch.py", "--arch", arch, "--device", "cpu")
    assert out.count("batch done: 4 reqs") == 3
    assert "served 12 requests / 144 tokens" in out


def test_train_example_runs_on_the_cpu():
    out = _run("train_lm_torch.py", "--device", "cpu", "--steps", "30")
    assert "training example OK" in out
