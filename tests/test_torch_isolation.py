"""The port stands alone: no JAX, nothing of the JAX package.

Subprocesses with ``jax`` and ``repro`` made unimportable run the port's
main path, its reduced serve path and its reduced training path on the CPU;
the compiler API and the compile daemon (``python -m repro_torch.daemon``
serving one compile) run with ``torch`` unimportable too. A scan of the
port's sources, ``chip_smoke.py`` and the port's examples finds no import of
either.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_MAIN_PATH = r'''
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now raises
import numpy as np
from repro_torch.core import CGRA, map_dfg, running_example
from repro_torch.core.simulate import interpret_dfg
from repro_torch.kernels.ops import cgra_run, compile_program
from repro_torch.kernels.ref import cgra_sim_reference

dfg = running_example()
res = map_dfg(dfg, CGRA(2, 2), deterministic=True)
assert res.ok and res.mapping.ii == 4, res.reason
prog = compile_program(res.mapping)
rng = np.random.default_rng(0)
inputs = {v: rng.uniform(-4, 4, (5, 8)).astype(np.float32).round(2)
          for v in prog.input_nodes()}
outs, trace = cgra_run(prog, inputs, 5, device="cpu")
_, ref = cgra_sim_reference(prog, inputs, 5)
assert np.array_equal(trace.numpy(), ref)
lane0 = interpret_dfg(dfg, {v: [float(x) for x in inputs[v][:, 0]] for v in inputs}, 5)
for v, stream in lane0.items():
    assert np.allclose(outs[v][:, 0].numpy(), stream, rtol=1e-6, atol=1e-6)
bad = [m for m in sys.modules
       if (m.split(".")[0] in ("jax", "jaxlib", "repro")) and sys.modules[m] is not None]
assert not bad, bad
print("MAIN_PATH_OK")
'''


def test_main_path_runs_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _MAIN_PATH], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "MAIN_PATH_OK" in proc.stdout


_API_PATH = r'''
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now raises
import tempfile
from repro_torch.api import Compiler, resolve_options
from repro_torch.core import CGRA
from repro_torch.core.benchsuite import load_suite
import repro_torch.compile
# the mapper's host stack never loads torch, so its pool forks from a
# process without a CUDA context
assert "torch" not in sys.modules
with tempfile.TemporaryDirectory() as d:
    comp = Compiler(CGRA(4, 4), resolve_options("fast", jobs=2, cache_dir=d))
    batch = comp.compile_batch(list(load_suite(["bitcount", "fft"]).values()))
    assert batch.ok and batch.num_workers == 2, batch.as_dict()
bad = [m for m in sys.modules
       if (m.split(".")[0] in ("jax", "jaxlib", "repro", "torch")) and sys.modules[m] is not None]
assert not bad, bad
print("API_PATH_OK")
'''


def test_api_path_runs_without_jax_the_jax_package_or_torch():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _API_PATH], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "API_PATH_OK" in proc.stdout


_DAEMON_PATH = r'''
import os, sys, tempfile, threading, time
for name in ("jax", "jaxlib", "repro", "torch"):
    sys.modules[name] = None          # any import of them now raises
from repro_torch.core import running_example
from repro_torch.core.daemon import DaemonClient, DaemonError
from repro_torch.daemon import main
tmp = tempfile.TemporaryDirectory()
sock = os.path.join(tmp.name, "d.sock")
seen = {}

def client():
    deadline = time.time() + 60
    while True:
        try:
            with DaemonClient(sock) as c:
                c.ping()
                seen["row"] = c.compile(running_example(), tenant="iso")
                seen["stats"] = c.stats()
                c.shutdown()
            return
        except DaemonError:
            if time.time() > deadline:
                return
            time.sleep(0.05)

t = threading.Thread(target=client)
t.start()
rc = main(["serve", "--socket", sock, "--size", "4", "--profile", "fast",
           "--workers", "1", "--quiet"])
t.join(timeout=60)
assert rc == 0 and seen["row"]["ok"] and seen["row"]["ii"] == 4, seen
assert seen["stats"]["completed"] == 1 and not os.path.exists(sock)
tmp.cleanup()
bad = [m for m in sys.modules
       if (m.split(".")[0] in ("jax", "jaxlib", "repro", "torch")) and sys.modules[m] is not None]
assert not bad, bad
print("DAEMON_PATH_OK")
'''


def test_daemon_serves_without_jax_the_jax_package_or_torch():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _DAEMON_PATH], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "DAEMON_PATH_OK" in proc.stdout


_SERVE_PATH = r'''
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now raises
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import main
main(["--arch", "gemma2-9b", "--reduced", "--device", "cpu", "--requests", "2",
      "--batch", "2", "--prompt-len", "20", "--gen", "3"])
assert flash_attention.launches == 0  # CPU tensors take the plain version
bad = [m for m in sys.modules
       if (m.split(".")[0] in ("jax", "jaxlib", "repro")) and sys.modules[m] is not None]
assert not bad, bad
print("SERVE_PATH_OK")
'''


def test_serve_path_runs_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _SERVE_PATH], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served 2 requests / 6 tokens" in proc.stdout
    assert "SERVE_PATH_OK" in proc.stdout


_TRAIN_PATH = r'''
import sys, tempfile
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now raises
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.launch.train import main
seen = {"backward": 0}
plain = flash_mod.flash_attention_backward_torch

def counted(*args, **kw):
    seen["backward"] += 1
    return plain(*args, **kw)

flash_mod.flash_attention_backward_torch = counted
with tempfile.TemporaryDirectory() as ckpt:
    report = main(["--arch", "gemma2-9b", "--reduced", "--device", "cpu", "--steps", "3",
                   "--batch", "2", "--seq", "24", "--grad-compression", "--ckpt-dir", ckpt])
assert report.steps_done == 3 and report.restarts == 0, report
assert seen["backward"] == 3 * 2      # one per layer per step, through the Function
assert flash_mod.flash_attention.backward_launches == 0   # CPU: the plain version
bad = [m for m in sys.modules
       if (m.split(".")[0] in ("jax", "jaxlib", "repro")) and sys.modules[m] is not None]
assert not bad, bad
print("TRAIN_PATH_OK")
'''


def test_train_path_runs_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _TRAIN_PATH], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "done: 3 steps" in proc.stdout
    assert "TRAIN_PATH_OK" in proc.stdout


_SOURCES = sorted(
    [p for p in (ROOT / "src" / "repro_torch").rglob("*")
     if p.suffix in (".py", ".cu", ".cuh")]
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
)
_FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+(jax|jaxlib)\b", re.M),
    re.compile(r"\bimport\s+repro\b(?!_)"),
    re.compile(r"\bfrom\s+repro\b(?!_)"),
    re.compile(r"\brepro\.(?!_)"),
]


@pytest.mark.parametrize("path", _SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_and_no_jax_package(path):
    text = path.read_text()
    hits = [m.group(0) for rx in _FORBIDDEN for m in rx.finditer(text)]
    assert not hits, f"{path.name}: {hits}"
