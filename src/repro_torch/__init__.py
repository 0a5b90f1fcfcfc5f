"""repro_torch: the PyTorch/CUDA port of the monomorphism-based CGRA mapper.

It sits beside the JAX package (``src/repro``), which stays the reference,
and mirrors its module paths:

core       the paper's mapping algorithm (CP time solver + exact
           monomorphism space engine), copied so that deterministic runs are
           bit-identical to the reference
obs        the stdlib span tracer the mapper calls
kernels    lowering of a mapping to per-step tables, and batched execution
           of the mapped loop on an NVIDIA GPU through a hand-written CUDA
           kernel (``kernels/csrc/cgra_sim.cu``); fused flash attention for
           the LM zoo, forward (``kernels/csrc/flash_attention.cu``) and
           backward (``kernels/csrc/flash_attention_bwd.cu``)
configs    the architecture registry (plain data)
models     the LM model zoo's dense family: layers, GQA attention, the
           decoder-LM assembly (with the training loss) and ``build_model``
optim      AdamW and int8 gradient compression with error feedback
data       synthetic and memmap token pipelines
checkpoint async, atomic, versioned checkpoints
runtime    the fault-tolerant training runner
launch     the serving and training entry points (``launch/serve.py``,
           ``launch/train.py``)
tree       walking parameter trees of dicts and lists in ``jax.tree`` order
interop    builds this package's objects from the plain data of a mapping,
           or from an LM parameter tree of numpy arrays, made elsewhere, and
           turns its LM trees back into that layout

The package imports torch, numpy and the standard library only. Entry points
that touch a device run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
