#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs a CUDA device (it exits 2 without one) and the CUDA toolkit, with
which the port builds its kernel into ``build/kernels/`` inside the checkout
on the first run. The last line of standard output is the run's result as
one JSON object; the last lines of standard error are the numbers compared,
each beside its limit. See ``perfbench/harness.py``.
"""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# this folder's modules are imported as perfbench.*, never by bare name
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

if __name__ == "__main__":
    from perfbench.harness import main

    sys.exit(main(t_start=T_START))
