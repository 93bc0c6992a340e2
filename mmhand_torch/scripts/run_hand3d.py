"""ColorHandPose3D demo with the PyTorch port (counterpart of
scripts/run_hand3d.py; reference hand_pose_estimators/CVPR2020_hand3d/
run.py:30-80): the whole pipeline over a list of images, with keypoint
overlays.

For each image: resize, HandSegNet -> crop -> PoseNet2D -> PosePrior and
ViewpointNet, the 21 detected keypoints drawn on the crop (a circle and
the index, as run.py:77-80), written as ``<name>_crop_kp.png`` beside a
``<name>_coord3d.json`` of the normalised 3D coordinates, the crop's scale
and centre.  Conditioned on the left hand, as the demo (run.py:41).

    python -m mmhand_torch.scripts.run_hand3d img1.png img2.png \\
        --out_dir demo_out [--checkpoints_dir ckpt --name hand3d]

The weights come from ``<checkpoints_dir>/<name>_full/state_latest.pt``
(its ``"module"``); without --checkpoints_dir, or without that file, they
are random (a warning says so) and the overlay means nothing.  The net runs
on ``--device`` (default cuda) in float32 with TF32 off.
"""

from __future__ import annotations

import argparse
import json
import warnings
from pathlib import Path

import numpy as np
import torch
from PIL import Image, ImageDraw

from mmhand_torch.eval.evaluator import full_fp32
from mmhand_torch.hand3d import load_color_hand_pose
from mmhand_torch.ops.hand3d_image import detect_keypoints


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("images", nargs="+")
    p.add_argument("--out_dir", default="hand3d_demo")
    p.add_argument("--checkpoints_dir", default=None)
    p.add_argument("--name", default="hand3d")
    p.add_argument("--size", type=int, default=256,
                   help="network input resize (the reference feeds "
                        "240x320; any size works, the pipeline crops to "
                        "crop_size)")
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="torch device to run the net on")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda was asked for, but torch sees no "
                           "CUDA device")

    net, found = load_color_hand_pose(args.checkpoints_dir, args.name,
                                      args.crop_size, device)
    if args.checkpoints_dir and not found:
        warnings.warn("no hand3d checkpoint found - demo runs with "
                      "RANDOM weights (overlay positions meaningless)")
    side = torch.tensor([[1.0, 0.0]], device=device)  # left hand (run.py:41)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for img_path in args.images:
        raw = Image.open(img_path).convert("RGB").resize(
            (args.size, args.size))
        x = torch.from_numpy(np.asarray(raw, np.float32) / 255.0 - 0.5)
        with full_fp32():
            _, crop, scale, center, kp_maps, coord3d = net(
                x[None].to(device), side)
            coords_hw = detect_keypoints(kp_maps)[0].cpu().numpy()
        crop_img = Image.fromarray(np.clip(
            (crop[0].cpu().numpy() + 0.5) * 255, 0, 255).astype(np.uint8))
        draw = ImageDraw.Draw(crop_img)
        for i, (y, xk) in enumerate(coords_hw):
            draw.ellipse([xk - 2, y - 2, xk + 2, y + 2],
                         outline=(255, 255, 255), width=2)
            draw.text((xk + 3, y - 3), str(i), fill=(255, 255, 255))

        stem = Path(img_path).stem
        crop_img.save(out_dir / f"{stem}_crop_kp.png")
        (out_dir / f"{stem}_coord3d.json").write_text(json.dumps({
            "keypoint_coord3d": coord3d[0].cpu().double().numpy()
            .round(5).tolist(),
            "scale": float(scale[0, 0]),
            "center": center[0].cpu().double().numpy().tolist(),
        }))
        print(f"{img_path}: wrote {stem}_crop_kp.png, {stem}_coord3d.json")
        written.append(stem)
    return written


if __name__ == "__main__":
    main()
