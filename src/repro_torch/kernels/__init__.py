"""The package's GPU kernels: batched execution of mapped CGRA programs,
and fused flash attention for the LM zoo.

ops.py              lowering of a mapping to per-step tables
                    (``compile_program``) and the executor entry point
                    (``cgra_run``)
cgra_sim.py         the cgra_sim kernel's wrapper, its plain PyTorch version
                    and its launch counter
flash_attention.py  the flash-attention kernels' wrappers (forward, with the
                    log-sum-exp, and backward), the autograd Function that
                    joins them, their plain PyTorch versions, the launch
                    counters and the padding path
csrc/               the hand-written CUDA sources, built at first use by
                    _build.py
ref.py              the oracles the kernels are held against

Importing the package installs ``obs``'s profiler hook, so that the
executor's spans (``exec.*``, ``cgra_sim.*``) and every other ``obs`` span
show in a ``torch.profiler`` trace as annotations.
"""

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function as _record_function

from .. import obs as _obs


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled


# obs spans become profiler annotations while torch.profiler records
_obs.install_profiler_hook(_profiling, _record_function)
