"""HPE evaluation with the PyTorch port: EPE and PCK-AUC over a test crop
tree (counterpart of scripts/test_hpe.py; reference
hand_pose_estimators/CVPR2020_hpm3d/test.py:39-50, models/hpm_model.py:
147-161, thresholds 0-30 px in 20 steps).

    python -m mmhand_torch.scripts.test_hpe --dataset RHD \\
        --dataroot /data/rhd_crop_test --name hpe_rhd_08

Reads the nets of ``<checkpoints_dir>/<name>/state_<which_epoch>.pt`` that
``train_hpe`` wrote and scores them through ``HPEJudge`` in float32 with
TF32 off.  ``--model hpm2d`` runs the judge with a random 3d net and prints
the 2d block only; ``--model hpm3d`` feeds the ground-truth sigma-5
heatmaps to the 3d net and prints its z error in pixels: |z - z_gt| times
--fineSize.  mmhand_tpu multiplies by a literal 256 there, which is the
same at 256 px and wrong at any other size.

It evaluates on ``--device`` (default cuda) and never moves to another
device on its own.
"""

from __future__ import annotations

import argparse
import warnings

import numpy as np
import torch

from mmhand_torch.config import Config, add_cli_args, from_cli_args
from mmhand_torch.eval import HPEJudge
from mmhand_torch.eval.evaluator import full_fp32
from mmhand_torch.hpe import HPEMixDataset, make_hpe_prepare_batch
from mmhand_torch.hpe.system import load_hpe_nets
from mmhand_torch.ops.image import normalize_image
from mmhand_torch.utils.checkpoint import CheckpointManager


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_cli_args(parser)
    parser.add_argument("--eval_batch", type=int, default=8)
    parser.add_argument("--model", default="hpm",
                        choices=("hpm", "hpm2d", "hpm3d"),
                        help="which trained variant to evaluate (reference "
                             "models/__init__.py:55-67)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to evaluate on")
    args = parser.parse_args(argv)
    cfg = from_cli_args(args, Config(is_train=False))
    return evaluate_hpe(cfg, args.model, args.eval_batch, args.device)


def evaluate_hpe(cfg: Config, variant: str = "hpm", eval_batch: int = 8,
                 device="cuda") -> dict:
    """Prints and returns {block: {epe_mean, epe_median[, auc]}} with the
    blocks "2d" and "3d" (``hpm``), "2d" (``hpm2d``) or "3d_z"
    (``hpm3d``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda was asked for, but torch sees no "
                           "CUDA device")
    size = cfg.model.fine_size
    path = CheckpointManager(cfg.run.checkpoints_dir, cfg.run.name).path(
        cfg.run.which_epoch)
    hpm2d, hpm3d = load_hpe_nets(path, size, device)
    needed = {"hpm": (hpm2d, hpm3d), "hpm2d": (hpm2d,), "hpm3d": (hpm3d,)}
    if any(net is None for net in needed[variant]):
        raise ValueError(f"{path} holds no net for --model {variant}")
    dataset = HPEMixDataset(cfg, is_train=False)
    n = len(dataset)
    if cfg.data.max_dataset_size:
        n = min(n, cfg.data.max_dataset_size)
    batches = [range(i, min(i + eval_batch, n))
               for i in range(0, n, eval_batch)]

    if variant == "hpm3d":
        prepare = make_hpe_prepare_batch(device=device)
        errs = []
        with full_fp32():
            for idx in batches:
                batch = prepare(dataset.batch(idx))
                z = hpm3d(batch["heatmaps"])
                errs.append(((z - batch["z"]).abs() * size).cpu().numpy())
        errs = np.concatenate(errs, axis=0)
        results = {"3d_z": {"epe_mean": float(np.mean(errs)),
                            "epe_median": float(np.median(errs))}}
        print("################# 3d (z only) #################")
        print(f"epe_mean: {results['3d_z']['epe_mean']:.4f}")
        print(f"epe_median: {results['3d_z']['epe_median']:.4f}")
        return results

    if variant == "hpm2d":
        # a 2d-only checkpoint has no z regressor: the judge runs with a
        # random 3d net and only the 2d block is reported
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            hpm3d = HPEJudge.random_init(size=size, device=device).hpm3d
    judge = HPEJudge(hpm2d, hpm3d, device=device)
    for idx in batches:
        raw = dataset.batch(idx)
        images = normalize_image(torch.from_numpy(raw["image"]).to(device))
        # raw z is depth / 0.7 (the training target); the judge divides the
        # ground truth's z by 700 and multiplies by 256, so raw_z * 700
        # lands it at depth / 0.7 * 256 px, the reference's pre-scaled
        # pseudo_xyz (RHD_dataset.py:135)
        xyz = np.concatenate([raw["uv"], (raw["z"] * 700.0)[:, :, None]], -1)
        judge.feed(images, xyz)
    r2d, r3d = judge.get_results(30, 20)
    blocks = [("2d", r2d)] if variant == "hpm2d" else [("2d", r2d),
                                                       ("3d", r3d)]
    results = {}
    for tag, r in blocks:
        results[tag] = {"epe_mean": float(r[0]), "epe_median": float(r[1]),
                        "auc": float(r[2])}
        print(f"################# {tag} #################")
        print(f"epe_mean: {r[0]:.4f}")
        print(f"epe_median: {r[1]:.4f}")
        print(f"auc: {r[2]:.4f}")
    return results


if __name__ == "__main__":
    main()
