"""Build the package's CUDA sources at first use and load them with ctypes.

Each source under ``kernels/csrc/`` exposes a plain C interface (no PyTorch
headers), so ``nvcc`` turns it into a shared library in seconds. The library
goes into ``build/`` at the root of the checkout, named by a digest of the
source, the headers beside it (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is reused. Targets Hopper
only (``sm_90a``). A failed build raises; nothing falls back to another
implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_BASE_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
)
_LIB_FLAGS = ("-shared", "-Xcompiler", "-fPIC")

# No fast math and no FMA contraction: cgra_sim must round exactly as
# numpy's float32 does.
NVCC_FLAGS = (*_BASE_FLAGS, "-fmad=false", *_LIB_FLAGS)

#: Flags of each kernel that does not take NVCC_FLAGS. The flash-attention
#: forward and backward are held to a tolerance, not bit for bit, so they
#: keep nvcc's FMA contraction (still no fast math: expf and tanhf stay
#: accurate). Each source is its own library, so the builds run in parallel.
KERNEL_FLAGS = {"flash_attention": (*_BASE_FLAGS, *_LIB_FLAGS),
                "flash_attention_bwd": (*_BASE_FLAGS, *_LIB_FLAGS)}

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` as PyTorch finds it, else
    ``nvcc`` on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH"
        )
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built to: named by a digest of the
    source, every header in ``csrc/`` (sources include them by name) and
    the flags. Needs no compiler."""
    src = _CSRC / f"{name}.cu"
    flags = KERNEL_FLAGS.get(name, NVCC_FLAGS)
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, *, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build/kernels`` unless already
    built; returns the library's path. ``verbose`` prints ptxas's report
    (registers, shared memory, spills) of each kernel."""
    src = _CSRC / f"{name}.cu"
    flags = KERNEL_FLAGS.get(name, NVCC_FLAGS)
    lib = library_path(name)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    return lib


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(build(name)))
        return _LOADED[name]
