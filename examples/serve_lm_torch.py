"""Batched serving example: a queue of requests through prefill + decode.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch gemma2-9b]
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The PyTorch twin of ``examples/serve_lm.py``: the reduced config of
``--arch`` served by ``repro_torch.launch.serve`` (12 requests in batches
of 4, prompts of 24 tokens, 12 generated), on CUDA unless ``--device``
names another device (on ``cpu`` attention takes its plain version).
"""

import argparse

from repro_torch.launch import serve as serve_mod

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="gemma2-9b")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

serve_mod.main([
    "--arch", args.arch,
    "--reduced",
    "--requests", "12",
    "--batch", "4",
    "--prompt-len", "24",
    "--gen", "12",
    "--device", args.device,
])
