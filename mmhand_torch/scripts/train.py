"""GAN training with the PyTorch port (counterpart of scripts/train.py;
reference train.py:10-65).

The command line keeps the reference's flag names (``mmhand_torch/config.py``);
a data-free run:

    python -m mmhand_torch.scripts.train --dataset synthetic --batchSize 16 \\
        --fineSize 256 --max_steps 6

It trains on ``--device`` (default cuda) and never moves to another device on
its own.  Without ``--vgg_npz`` (tools/convert_torch_weights.py) the
perceptual term runs on random VGG19 weights, with a warning.  Dropout masks
come from ``torch.manual_seed(--seed)``.
"""

from __future__ import annotations

import argparse

import torch

from mmhand_torch.config import Config, add_cli_args, from_cli_args
from mmhand_torch.train.loop import TrainResult, train


def main(argv=None) -> TrainResult:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_cli_args(parser)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N optimizer steps (smoke runs)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override total epochs (default niter+niter_decay)")
    parser.add_argument("--vgg_npz", type=str, default=None,
                        help="converted VGG19 weights "
                             "(tools/convert_torch_weights.py)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on")
    args = parser.parse_args(argv)

    cfg = from_cli_args(args, Config())
    torch.manual_seed(cfg.data.seed)
    result = train(cfg, device=args.device, max_steps=args.max_steps,
                   vgg_npz=args.vgg_npz, total_epochs=args.epochs)
    rate = ("" if result.images_per_sec is None else
            f"; {result.images_per_sec:.2f} images/s after the first step")
    print(f"done: {result.steps} steps{rate}, last metrics: "
          f"{ {k: round(v, 4) for k, v in result.last_metrics.items()} }")
    return result


if __name__ == "__main__":
    main()
