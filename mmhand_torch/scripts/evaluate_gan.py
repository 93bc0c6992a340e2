"""Image-quality + pose-consistency evaluation of a trained generator with
the PyTorch port (counterpart of scripts/evaluate_gan.py; "benchmark 1",
reference scripts/README.md:1-6 through Evaluator utils.py:12-139).

Sweeps the test split, generates fakes from (source image, target pose,
target depth) conditioning, and reports {IS_avg/std, SSIM_avg/std,
pck2d_auc, pck3d_auc, fid} with images/s, as one JSON line.

    python -m mmhand_torch.scripts.evaluate_gan --dataset RHD \\
        --dataroot /data/rhd_test --name rhd_256 \\
        [--inception_npz inception_v3.npz] \\
        [--hpm2d_npz w2d.npz --hpm3d_npz w3d.npz]

The generator comes from ``<checkpoints_dir>/<name>/<which_epoch>_net_netG.pth``
or from ``--torch_netG``.  Without converted weights the Inception and CPM
nets are random: the numbers are structural only, and the JSON says so in
'weights'.  Each batch is scored on ``--device`` (default cuda) as it comes;
no batch of images is kept after it is scored.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from mmhand_torch.config import Config, add_cli_args, from_cli_args
from mmhand_torch.data import HostLoader, build_dataset, make_prepare_batch
from mmhand_torch.eval import Evaluator, HPEJudge
from mmhand_torch.models.cpm import Hpm2d, Hpm3d, load_cpm_npz
from mmhand_torch.models.inception import load_inception_npz
from mmhand_torch.train.state import build_generator
from mmhand_torch.train.step import make_eval_step
from mmhand_torch.utils.checkpoint import load_state_dict, network_path


def add_eval_args(parser: argparse.ArgumentParser) -> None:
    """The scoring flags shared with bench_baselines."""
    parser.add_argument("--inception_npz", type=str, default=None)
    parser.add_argument("--hpm2d_npz", type=str, default=None)
    parser.add_argument("--hpm3d_npz", type=str, default=None)
    parser.add_argument("--no_pck", action="store_true",
                        help="skip the CPM judge (faster)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to evaluate on")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    add_cli_args(parser)
    add_eval_args(parser)
    parser.add_argument("--eval_batch", type=int, default=16)
    parser.add_argument("--ssim_quirk", action="store_true",
                        help="reproduce the reference SSIM range quirk "
                             "(pred in [-1,1] vs gt in [0,1]; reference "
                             "baselines/quantitative_on_benchmarks/"
                             "utils.py:100-111) for 1:1 harness A/Bs")
    parser.add_argument("--torch_netG", type=str, default=None,
                        help="generator state_dict (.pth or .npz dump) to use "
                             "instead of the checkpoint under --name")
    args = parser.parse_args(argv)
    cfg = from_cli_args(args, Config(is_train=False))
    state_dict = load_state_dict(args.torch_netG) if args.torch_netG else None
    scores = evaluate(cfg, batch_size=args.eval_batch, device=args.device,
                      state_dict=state_dict, inception_npz=args.inception_npz,
                      hpm2d_npz=args.hpm2d_npz, hpm3d_npz=args.hpm3d_npz,
                      with_pck=not args.no_pck, ssim_quirk=args.ssim_quirk)
    print(json.dumps({k: (v if isinstance(v, str) else round(float(v), 4))
                      for k, v in scores.items()}))
    return scores


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda was asked for, but torch sees no "
                           "CUDA device")
    return device


def build_evaluator(size: int, device, inception_npz: Optional[str] = None,
                    hpm2d_npz: Optional[str] = None,
                    hpm3d_npz: Optional[str] = None, with_pck: bool = True,
                    ssim_quirk: bool = False) -> Evaluator:
    """The Evaluator and its judge, from converted weights where given and
    random ones (with a warning) where not."""
    judge = None
    if with_pck:
        if hpm2d_npz and hpm3d_npz:
            hpm2d, hpm3d = Hpm2d(), Hpm3d(size=size)
            hpm2d.load_state_dict(load_cpm_npz(hpm2d_npz))
            hpm3d.load_state_dict(load_cpm_npz(hpm3d_npz))
            judge = HPEJudge(hpm2d, hpm3d, device=device)
        else:
            judge = HPEJudge.random_init(size=size, device=device)
    inception = load_inception_npz(inception_npz) if inception_npz else None
    return Evaluator(inception, judge, ssim_quirk=ssim_quirk, device=device)


def target_xyz(raw: dict) -> Optional[np.ndarray]:
    """(B, 21, 3) target keypoints with raw depth in the z column, or None
    for prerendered datasets (MMHand CSV), which carry no uv/z: PCK is
    skipped for them, like the reference's pose-map-only path."""
    if "tgt_uv" not in raw:
        return None
    return np.concatenate([raw["tgt_uv"], raw["tgt_z"][:, :, None]], axis=-1)


class Rate:
    """images/s over the whole sweep and after its first batch, which pays
    for cuDNN's autotuning and the kernels' build."""

    def __init__(self):
        self.images = 0
        self.start = time.perf_counter()
        self.first: Optional[tuple[int, float]] = None

    def add(self, n: int) -> None:
        self.images += n
        if self.first is None:
            self.first = (self.images, time.perf_counter())

    def scores(self) -> dict:
        end = time.perf_counter()
        out = {"images": self.images,
               "images_per_sec": self.images / (end - self.start)}
        if self.first is not None and self.images > self.first[0]:
            out["images_per_sec_steady"] = (
                (self.images - self.first[0]) / (end - self.first[1]))
        return out


def evaluate(cfg: Config, batch_size: int = 16, device="cuda",
             state_dict: Optional[dict] = None,
             inception_npz: Optional[str] = None,
             hpm2d_npz: Optional[str] = None, hpm3d_npz: Optional[str] = None,
             with_pck: bool = True, ssim_quirk: bool = False) -> dict:
    """Score the generator over the test split; returns the score dict."""
    device = check_device(device)
    if state_dict is None:
        state_dict = load_state_dict(network_path(
            cfg.run.checkpoints_dir, cfg.run.name, cfg.run.which_epoch))
    generator = build_generator(cfg, device)
    generator.load_state_dict(state_dict)
    eval_step = make_eval_step(generator)
    evaluator = build_evaluator(cfg.model.fine_size, device, inception_npz,
                                hpm2d_npz, hpm3d_npz, with_pck, ssim_quirk)

    loader = HostLoader(build_dataset(cfg), batch_size, seed=cfg.data.seed,
                        shuffle=False, drop_last=False,
                        max_items=cfg.data.max_dataset_size)
    prepare = make_prepare_batch(cfg.data.sigma, device)
    rate = Rate()
    for raw in loader.epoch(0):
        batch = prepare({k: v for k, v in raw.items()
                         if not k.endswith("paths")})
        fakes = eval_step(batch)
        evaluator.feed(fakes, batch["H2"], target_xyz(raw))
        rate.add(int(fakes.shape[0]))
    if rate.images == 0:
        raise SystemExit(
            "evaluate_gan: the dataset produced no eval pairs.  A dataroot "
            "whose path lacks 'test' uses the generate-mode complement "
            "split (reference generic_dataset.py:114-121): with "
            "--augmentation_ratio 1.0 the complement is empty — pass a "
            "ratio < 1, or point --dataroot at a *test* tree.")
    timing = rate.scores()
    return {**evaluator.evaluate(), **timing}


if __name__ == "__main__":
    main()
