"""End-to-end training driver: the reduced qwen3-family model for a few
hundred steps on synthetic data, with checkpointing + the fault-tolerant
runner.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 30

The PyTorch twin of ``examples/train_lm.py``, through
``repro_torch.launch.train``, on CUDA unless ``--device`` names another
device. The checkpoints go to a fresh temporary directory, removed at the
end; the loss must decrease.
"""

import argparse
import tempfile

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as ckpt:
        report = train_mod.main([
            "--arch", args.arch,
            "--steps", str(args.steps),
            "--batch", "8",
            "--seq", "128",
            "--reduced",
            "--ckpt-dir", ckpt,
            "--device", args.device,
        ])
    assert report.losses[-1] < report.losses[0], "loss must decrease"
    print("training example OK — loss decreased "
          f"{report.losses[0]:.3f} -> {report.losses[-1]:.3f}")


if __name__ == "__main__":
    main()
