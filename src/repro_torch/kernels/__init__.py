"""Batched execution of mapped CGRA programs on a GPU.

ops.py          lowering of a mapping to per-step tables (``compile_program``)
                and the executor entry point (``cgra_run``)
cgra_sim.py     the CUDA kernel's wrapper, its plain PyTorch version and its
                launch counter
csrc/           the hand-written CUDA sources, built at first use by _build.py
ref.py          the numpy oracle the executor is held against
"""
