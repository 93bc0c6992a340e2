"""An independent hand-landmark judge with the PyTorch port: ground-truth
and generated keypoints as JSON (counterpart of scripts/handpose_judge.py;
reference baselines/tf-handpose/test.js:1-31, utilities.js:1-21).

Given a directory whose first two files, in sorted order, are the ground
truth and the generated image, it runs a hand-pose estimator on both and
writes ``gt_js.json`` and ``pred_js.json`` beside them in the
tfjs-handpose layout ([{handInViewConfidence, landmarks: [[x, y, z] x 21]}]).
The reference's pretrained browser model has no counterpart here; its
role, a judge that never saw MM-Hand's training, is played by the
ColorHandPose3D pipeline (--judge hand3d) or the CPM judge (--judge cpm).
The images are resized to 256x256 with nearest neighbour, as
utilities.js loadTensor.

    python -m mmhand_torch.scripts.handpose_judge SAMPLE_DIR \\
        [--judge hand3d|cpm] [--checkpoints_dir ckpt]

--judge hand3d reads ``<checkpoints_dir>/hand3d_full/state_latest.pt``
(its ``"module"``); without it the weights are random and a warning says
so.  --judge cpm reads --hpm2d_npz and --hpm3d_npz, else random weights.
The nets run on ``--device`` (default cuda) in float32 with TF32 off.
"""

from __future__ import annotations

import argparse
import json
import warnings
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from mmhand_torch.eval.evaluator import HPEJudge, full_fp32
from mmhand_torch.hand3d import load_color_hand_pose
from mmhand_torch.models.cpm import Hpm2d, Hpm3d, load_cpm_npz
from mmhand_torch.ops.hand3d_image import detect_keypoints


def load_tensor(path, size: int = 256) -> np.ndarray:
    """utilities.js loadTensor: decode, nearest-neighbour resize."""
    img = Image.open(path).convert("RGB")
    return np.asarray(img.resize((size, size), Image.NEAREST), np.float32)


def estimate_hands_hand3d(images: np.ndarray, ckpt_dir=None,
                          name: str = "hand3d", device="cuda",
                          crop_size: int = 256) -> np.ndarray:
    """21 (x, y, z) landmarks per image by ColorHandPose3D: x and y from
    PoseNet's argmax in the image's frame, z from the lifted normalised 3D
    (reference run.py:55-60)."""
    net, found = load_color_hand_pose(ckpt_dir, name, crop_size, device)
    if ckpt_dir and not found:
        warnings.warn("no hand3d checkpoint found - judging with "
                      "RANDOM weights; landmarks are structural only")
    x = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    x = x / 255.0 - 0.5
    side = torch.tensor([[1.0, 0.0]], device=device).expand(len(x), 2)
    with full_fp32():
        _, _, scale, center, kp_maps, coord3d = net(x, side)
        coords_hw = detect_keypoints(kp_maps).cpu().numpy()  # crop frame
    # back to the image's frame (reference utils/general.py:348-357)
    center = center.cpu().numpy()[:, None, :]
    scale = scale.cpu().numpy()[:, None, :]
    coords_hw = (coords_hw - crop_size // 2) / scale + center
    z = coord3d.cpu().numpy()[:, :, 2:3]
    return np.concatenate([coords_hw[:, :, ::-1], z], axis=2)


def estimate_hands_cpm(images: np.ndarray, hpm2d_npz=None, hpm3d_npz=None,
                       device="cuda") -> np.ndarray:
    """Landmarks by the CPM judge (evaluate_gan's HPEJudge)."""
    size = images.shape[1]
    if hpm2d_npz and hpm3d_npz:
        hpm2d, hpm3d = Hpm2d(), Hpm3d(size=size)
        hpm2d.load_state_dict(load_cpm_npz(hpm2d_npz))
        hpm3d.load_state_dict(load_cpm_npz(hpm3d_npz))
        judge = HPEJudge(hpm2d, hpm3d, device=device)
    else:
        judge = HPEJudge.random_init(size=size, device=device)
    x = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    px, py, z = (t.cpu().numpy() for t in judge.predict(x / 127.5 - 1.0))
    return np.stack([px, py, z], axis=2)


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("sample_dir")
    p.add_argument("--judge", choices=["hand3d", "cpm"], default="hand3d")
    p.add_argument("--size", type=int, default=256,
                   help="judge input resize (utilities.js uses 256)")
    p.add_argument("--checkpoints_dir", default=None)
    p.add_argument("--hpm2d_npz", default=None)
    p.add_argument("--hpm3d_npz", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run the judge on")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda was asked for, but torch sees no "
                           "CUDA device")

    sample = sorted(
        f for f in Path(args.sample_dir).iterdir()
        if f.suffix.lower() in (".png", ".jpg", ".jpeg"))
    if len(sample) < 2:
        raise ValueError(f"{args.sample_dir} needs [gt, generated] images")
    images = np.stack([load_tensor(sample[0], args.size),
                       load_tensor(sample[1], args.size)])
    if args.judge == "hand3d":
        lm = estimate_hands_hand3d(images, args.checkpoints_dir,
                                   device=device)
    else:
        lm = estimate_hands_cpm(images, args.hpm2d_npz, args.hpm3d_npz,
                                device)
    for fname, landmarks in (("gt_js.json", lm[0]), ("pred_js.json", lm[1])):
        out = [{"handInViewConfidence": 1.0,
                "landmarks": np.asarray(landmarks, np.float64)
                .round(4).tolist()}]
        path = Path(args.sample_dir) / fname
        path.write_text(json.dumps(out))
        print("The file has been saved!", path)
    return lm


if __name__ == "__main__":
    main()
