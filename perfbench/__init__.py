"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

One run of one cell::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, metrics and bounds are in ``BENCHMARK.json`` at the root of the
checkout. Everything a cell needs is found by name under this folder:

* ``configs/<config>.json``: the fabric and the compiler options;
* ``workloads/<cell>.json``: the cell's kind and traffic parameters;
* ``drivers/<kind>.py``: the set-up, the measured window and the check of
  one kind of cell;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``data/dfgs/<kernel>.json`` and ``data/mappings/<config>/<kernel>.json``:
  the frozen inputs, written once by ``freeze.py``.

The yardstick lives here too and imports nothing of the port: the plain
NumPy interpreter of a DFG (``reference.py``), the legality checker and mII
(``legality.py``), the input generator (``inputs.py``), the table of peaks
and the executor's bound (``roofline.py``) and the trace arithmetic
(``trace.py``). Nothing here imports ``jax`` or the JAX package ``repro``.
"""
