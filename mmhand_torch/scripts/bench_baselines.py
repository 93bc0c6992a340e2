"""Baseline-judge benchmarks with the PyTorch port (counterpart of
scripts/bench_baselines.py; reference baselines/quantitative_on_benchmarks/
bench_p2p.py, bench_cyclegan.py).

Scores a baseline generator over the test split with the same metric engine
as the MM-Hand model (IS/SSIM/FID/PCK):

* --arch patn2   PoseTransfer's 2-stream PATN generator (9 blocks), input
                 (source image H1, cat(P1, P2)): the 21-channel heatmaps of
                 both poses, rendered by kernel K1 on the card
* --arch resnet  CycleGAN resnet generator (9 ResnetBlocks)
* --arch unet    pix2pix UNet (8 levels)

The jointsmap baselines take the depth-coloured bone jointsmap of the target
pose (kernel K3 on the card), min-max normalized to [0, 1] and repeated to 3
channels.

    python -m mmhand_torch.scripts.bench_baselines --arch unet --dataset RHD \\
        --dataroot /data/rhd_crop_test [--ckpt latest_net_G.pth]

``--ckpt`` is a state_dict (.pth or .npz dump) in the reference torch layout
(for resnet and unet the one tools/convert_baselines_torch.py reads; for
patn2 PoseTransfer's, or the port's); without it the generator is random,
with a warning.  Prints one JSON line of scores.
"""

from __future__ import annotations

import argparse
import json
import warnings
from typing import Optional

import numpy as np
import torch

from mmhand_torch.config import Config, add_cli_args, from_cli_args
from mmhand_torch.data import HostLoader, build_dataset, make_prepare_batch
from mmhand_torch.eval import Evaluator
from mmhand_torch.models.baselines import (
    PATN2Stream,
    ResnetGenerator,
    UnetGenerator,
)
from mmhand_torch.models.layers import NormConfig, init_weights
from mmhand_torch.scripts.evaluate_gan import (
    Rate,
    add_eval_args,
    build_evaluator,
    check_device,
    target_xyz,
)
from mmhand_torch.train.state import compute_dtype
from mmhand_torch.utils.checkpoint import load_state_dict


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    add_cli_args(parser)
    add_eval_args(parser)
    parser.add_argument("--arch", required=True,
                        choices=["patn2", "resnet", "unet"])
    parser.add_argument("--ckpt", default=None,
                        help="generator state_dict (.pth or .npz dump) in the "
                             "reference torch layout (random init if omitted)")
    parser.add_argument("--eval_batch", type=int, default=8)
    args = parser.parse_args(argv)
    cfg = from_cli_args(args, Config(is_train=False))
    scores = bench(cfg, args.arch, batch_size=args.eval_batch,
                   device=args.device, ckpt=args.ckpt,
                   inception_npz=args.inception_npz,
                   hpm2d_npz=args.hpm2d_npz, hpm3d_npz=args.hpm3d_npz,
                   with_pck=not args.no_pck)
    print(json.dumps({"arch": args.arch,
                      **{k: (v if isinstance(v, str) else round(float(v), 4))
                         for k, v in scores.items()}}))
    return scores


def build_baseline(cfg: Config, arch: str, device, ckpt: Optional[str] = None,
                   n_blocks: int = 9, num_downs: int = 8):
    """The baseline generator on ``device`` (channels_last, eval mode), from
    ``ckpt`` or drawn from ``cfg.data.seed``."""
    m = cfg.model
    dtype = compute_dtype(cfg.precision.compute_dtype)
    norm = NormConfig(kind=m.norm)
    if arch == "patn2":
        net = PATN2Stream(output_nc=m.output_nc, ngf=m.ngf, n_blocks=n_blocks,
                          norm=norm, compute_dtype=dtype)
    elif arch == "resnet":
        net = ResnetGenerator(output_nc=m.output_nc, ngf=m.ngf,
                              n_blocks=n_blocks, norm=norm,
                              compute_dtype=dtype)
    elif arch == "unet":
        net = UnetGenerator(output_nc=m.output_nc, num_downs=num_downs,
                            ngf=m.ngf, norm=norm, compute_dtype=dtype)
    else:
        raise ValueError(f"unknown --arch {arch}")
    if ckpt:
        sd = load_state_dict(ckpt)
        # load_state_dict strips the reference's top-level ``model.``; the
        # UNet's own keys keep it
        own = net.state_dict().keys()
        if set(sd) != set(own) and {f"model.{k}" for k in sd} == set(own):
            sd = {f"model.{k}": v for k, v in sd.items()}
        net.load_state_dict(sd)
    else:
        warnings.warn(f"bench_baselines: --arch {arch} runs with RANDOM "
                      "generator weights (pass --ckpt)", stacklevel=2)
        init_weights(net, m.init_type,
                     torch.Generator().manual_seed(cfg.data.seed))
    return net.to(device=device, memory_format=torch.channels_last).eval()


def jointsmap_condition(raw: dict, size: int, device) -> torch.Tensor:
    """The baselines' input: ``create_input_image`` of the target pose with
    z/700*255 (scripts/bench_baselines.py:111-113), scaled on the host as
    mmhand_tpu scales it, rasterized on ``device``."""
    z = np.asarray(raw["tgt_z"]) / 700.0 * 255.0
    xyz = np.concatenate([np.asarray(raw["tgt_uv"], np.float32),
                          np.asarray(z, np.float32)[..., None]], axis=-1)
    return Evaluator.create_input_image(torch.from_numpy(xyz).to(device), size)


def bench(cfg: Config, arch: str, batch_size: int = 8, device="cuda",
          ckpt: Optional[str] = None, n_blocks: int = 9, num_downs: int = 8,
          inception_npz: Optional[str] = None,
          hpm2d_npz: Optional[str] = None, hpm3d_npz: Optional[str] = None,
          with_pck: bool = True) -> dict:
    """Score one baseline over the test split; returns the score dict."""
    device = check_device(device)
    size = cfg.model.fine_size
    net = build_baseline(cfg, arch, device, ckpt, n_blocks, num_downs)
    evaluator = build_evaluator(size, device, inception_npz, hpm2d_npz,
                                hpm3d_npz, with_pck)
    loader = HostLoader(build_dataset(cfg), batch_size, seed=cfg.data.seed,
                        shuffle=False, drop_last=False,
                        max_items=cfg.data.max_dataset_size)
    prepare = make_prepare_batch(cfg.data.sigma, device)
    rate = Rate()
    for raw in loader.epoch(0):
        batch = prepare({k: v for k, v in raw.items()
                         if not k.endswith("paths")})
        with torch.inference_mode():
            if arch == "patn2":
                fakes = net((batch["H1"],
                             torch.cat([batch["P1"], batch["P2"]], -1)))
            else:
                fakes = net(jointsmap_condition(raw, size, device))
        evaluator.feed(fakes, batch["H2"], target_xyz(raw))
        rate.add(int(fakes.shape[0]))
    timing = rate.scores()
    return {**evaluator.evaluate(), **timing}


if __name__ == "__main__":
    main()
