"""hand3d evaluation with the PyTorch port (counterpart of
scripts/eval_hand3d.py): 2D PoseNet and 3D lifting EPE and AUC.

* --mode 2d: PoseNet on ground-truth crops, the argmax keypoints in
  EvalUtil over 0-30 px in 20 steps (reference
  hand_pose_estimators/CVPR2020_hand3d/eval2d_gt_cropped.py:38-93);
* --mode 3d: the PosePriorNetwork variant on ground-truth scoremaps, the
  prediction times keypoint_scale against the root-centred ground truth,
  over 0-0.050 m in 20 steps (reference eval3d.py:60-105);
* --mode full: ColorHandPose3D on whole frames (reference eval_full.py's
  role), scored as 3d.

It reads the packed binary GAN DB (or synthetic records) and the
checkpoints of ``mmhand_torch.scripts.train_hand3d``:
``<name>_posenet`` and ``<name>_lifting``, and for --mode full a
``<name>_full/state_latest.pt`` whose ``"module"`` holds a ColorHandPose3D
state_dict; without one the net has random weights, as in mmhand_tpu.  The
nets run on ``--device`` (default cuda) in float32 with TF32 off.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mmhand_torch.data.hand3d_binary import Hand3dBinaryDataset
from mmhand_torch.eval.evaluator import full_fp32
from mmhand_torch.eval.metrics import EvalUtil
from mmhand_torch.hand3d import (
    Hand3DSystem,
    PipelineConfig,
    derive_batch,
    load_color_hand_pose,
)
from mmhand_torch.models.hand3d import LIFTING_VARIANTS
from mmhand_torch.ops.hand3d_image import detect_keypoints, resize_bilinear_tf1
from mmhand_torch.scripts.train_hand3d import (
    records_to_pipeline_batch,
    synthetic_records,
)
from mmhand_torch.utils.checkpoint import CheckpointManager


def _subnet(net: str, args, device) -> torch.nn.Module:
    """The trained subnet of ``<name>_<net>``, random where none was
    saved."""
    system = Hand3DSystem(net=net, variant=args.variant,
                          crop_size=args.crop_size, device=device)
    ckpt = CheckpointManager(args.checkpoints_dir, f"{args.name}_{net}")
    if ckpt.has("latest"):
        ckpt.restore(system, "latest")
    return system.module.eval()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["2d", "3d", "full"], default="2d")
    p.add_argument("--variant", default="proposed", choices=LIFTING_VARIANTS)
    p.add_argument("--bin", default=None)
    p.add_argument("--name", default="hand3d")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda was asked for, but torch sees no "
                           "CUDA device")

    size = (args.image_size, args.image_size)
    if args.bin:
        ds = Hand3dBinaryDataset(args.bin, args.image_size, args.image_size)
        records = [ds[i] for i in range(len(ds))]
    else:
        records = synthetic_records(max(args.batch_size, 8),
                                    args.image_size)
    if args.max_samples:
        records = records[:args.max_samples]

    # the evaluation reader flags (reference eval3d.py:48,
    # eval2d_gt_cropped.py:37)
    cfg = PipelineConfig(image_size=size, crop_size=args.crop_size,
                         use_wrist_coord=False,
                         hand_crop=(args.mode != "full"))
    if args.mode == "2d":
        net = _subnet("posenet", args, device)

        def predict(batch):
            maps = net(batch["image_crop"])[-1]
            maps = resize_bilinear_tf1(maps, batch["image_crop"].shape[1:3])
            return detect_keypoints(maps)                    # (B, 21, 2) y, x
    elif args.mode == "3d":
        net = _subnet("lifting", args, device)

        def predict(batch):
            return net(batch["scoremap"], batch["hand_side"])[0]
    else:
        net, _ = load_color_hand_pose(args.checkpoints_dir, args.name,
                                      args.crop_size, device)

        def predict(batch):
            return net(batch["image"], batch["hand_side"])[5]

    util = EvalUtil(num_kp=21)
    b = args.batch_size
    gen = torch.Generator().manual_seed(0)  # no noise flag is on
    for i in range(0, len(records), b):
        raw = records_to_pipeline_batch(records[i:i + b])
        batch = derive_batch(raw, cfg, gen, device)
        with full_fp32():
            pred = predict(batch).cpu().numpy()
        if args.mode == "2d":
            uv_pred = pred[:, :, ::-1]
            uv_gt = batch["keypoint_uv21"].cpu().numpy()
            vis = batch["keypoint_vis21"].cpu().numpy()
            crop_scale = batch["crop_scale"][:, 0].cpu().numpy()
            for j, s in enumerate(crop_scale):
                util.feed(uv_gt[j] / s, vis[j], uv_pred[j] / s)
        else:
            gt = batch["keypoint_xyz21"].cpu().numpy()
            scale = batch["keypoint_scale"][:, 0].cpu().numpy()
            for j, s in enumerate(scale):
                # to metres, the ground truth root-centred (reference
                # eval3d.py:85-95)
                util.feed(gt[j] - gt[j][0:1], np.ones(21), pred[j] * s)

    if args.mode == "2d":
        mean, median, auc, _, _ = util.get_measures(0.0, 30.0, 20)
        unit = "pixels"
    else:
        mean, median, auc, _, _ = util.get_measures(0.0, 0.050, 20)
        mean, median = mean * 1000, median * 1000
        unit = "mm"
    print(f"Evaluation results ({args.mode}):")
    print(f"Average mean EPE: {mean:.3f} {unit}")
    print(f"Average median EPE: {median:.3f} {unit}")
    print(f"Area under curve: {auc:.3f}")
    return {"mean": float(mean), "median": float(median), "auc": float(auc)}


if __name__ == "__main__":
    main()
