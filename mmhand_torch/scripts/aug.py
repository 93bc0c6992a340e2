"""Synthetic data generation with the PyTorch port (counterpart of
scripts/aug.py; reference aug.py:12-71).

Loads a generator state_dict, sweeps the augmentation split of the dataset
(the (1-ratio) complement the GAN never trained on, or the whole test set),
and writes fake PNGs mirroring the target path under DST: DST/<folder>/<name>.

    python -m mmhand_torch.scripts.aug --name rhd_256 --dataroot /data/rhd_crop \\
        --dataset RHD --augmentation_ratio 0.8 --dst /data/rhd_fake

The generator comes from ``<checkpoints_dir>/<name>/<which_epoch>_net_netG.pth``
or from ``--torch_netG`` (a reference or port state_dict, or its .npz dump).
It runs on ``--device`` (default cuda), and never moves to another device on
its own.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch

from mmhand_torch.config import Config, add_cli_args, from_cli_args
from mmhand_torch.data import HostLoader, build_dataset, make_prepare_batch
from mmhand_torch.ops.image import denormalize_image
from mmhand_torch.train.state import build_generator
from mmhand_torch.train.step import make_eval_step
from mmhand_torch.utils.checkpoint import load_state_dict, network_path
from mmhand_torch.utils.png import write_png


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_cli_args(parser)
    parser.add_argument("--dst", type=str, required=True,
                        help="output root for fake images")
    parser.add_argument("--gen_batch", type=int, default=16)
    parser.add_argument("--torch_netG", type=str, default=None,
                        help="generator state_dict (.pth or .npz dump) to use "
                             "instead of the checkpoint under --name")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to generate on")
    args = parser.parse_args(argv)

    cfg = from_cli_args(args, Config(is_train=False))
    state_dict = load_state_dict(args.torch_netG) if args.torch_netG else None
    return generate(cfg, args.dst, batch_size=args.gen_batch,
                    device=args.device, state_dict=state_dict)


def generate(cfg: Config, dst: str, batch_size: int = 16, device="cuda",
             state_dict: Optional[dict] = None) -> int:
    """Run the generator over the aug split; returns #images written."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda was asked for, but torch sees no "
                           "CUDA device")
    if state_dict is None:
        state_dict = load_state_dict(network_path(
            cfg.run.checkpoints_dir, cfg.run.name, cfg.run.which_epoch))
    generator = build_generator(cfg, device)
    generator.load_state_dict(state_dict)
    eval_step = make_eval_step(generator)

    dataset = build_dataset(cfg)
    loader = HostLoader(dataset, batch_size, seed=cfg.data.seed,
                        shuffle=False, drop_last=False,
                        max_items=cfg.data.max_dataset_size)
    prepare = make_prepare_batch(cfg.data.sigma, device)

    written = 0
    first = None  # (images, clock) when the first batch was written
    for raw in loader.epoch(0):
        batch = prepare({k: v for k, v in raw.items()
                         if not k.endswith("paths")})
        # denormalize on the device and fetch uint8: 4x less traffic
        fakes = denormalize_image(eval_step(batch)).cpu().numpy()
        for i, tgt_path in enumerate(raw["tgt_paths"]):
            folder = os.path.basename(os.path.dirname(tgt_path))
            name = os.path.basename(tgt_path)
            out_dir = os.path.join(dst, folder)
            os.makedirs(out_dir, exist_ok=True)
            write_png(os.path.join(out_dir, name), fakes[i])
            written += 1
        if first is None:
            first = (written, time.perf_counter())
    rate = ""
    if first is not None and written > first[0]:
        steady = (written - first[0]) / (time.perf_counter() - first[1])
        rate = f"; {steady:.2f} images/s after the first batch"
    print(f"wrote {written} fakes under {dst}{rate}")
    return written


if __name__ == "__main__":
    main()
