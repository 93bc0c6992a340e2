"""Export a crop tree into the input formats of the baseline repos, with the
PyTorch port (counterpart of scripts/export_baseline_formats.py; reference
baselines/PoseTransfer_convert_RHD.py, PG2_convert_*.py,
pix2pixHD_convert_synthetic_hands.py, label2colormap.py).

Modes:
  pairs       a random (from, to) pair CSV over the crop tree, one pair per
              image (PoseTransfer/PG2; reference PoseTransfer_convert_RHD.py:
              17-45)
  keypoints   a ``name:keypoints_y:keypoints_x`` CSV, the input of
              ``generate_pose_maps``
  pix2pixhd   label maps (the depth-ordered jointsmap, bone colours as
              label ids) and image copies in pix2pixHD's
              train_label/train_img layout; the labels are rasterized on
              ``--device`` in batches of ``--batch`` (kernel K3 on the card)

    python -m mmhand_torch.scripts.export_baseline_formats pairs /data/img/train pairs.csv
    python -m mmhand_torch.scripts.export_baseline_formats keypoints /data/img/train annos.csv
    python -m mmhand_torch.scripts.export_baseline_formats pix2pixhd /data/img/train /data/p2phd

Names in both CSVs are ``<folder>/<image>`` with the extension kept
(``color/00000.png``), so ``generate_pose_maps`` writes
``color/00000.png.npy``, the file ``--dataset MMHand`` reads for that pair
name.  mmhand_tpu's ``keypoints`` drops the extension there, and its chain
stops at a missing ``.npy``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import random

import numpy as np
import torch

from mmhand_torch.data.annotations import load_annotations
from mmhand_torch.ops.jointsmap import generate_jointsmap
from mmhand_torch.scripts.evaluate_gan import check_device


def _color_images(annotations):
    if "color" in annotations:
        return [("color", name) for name in sorted(annotations["color"])]
    return [(folder, name) for folder in sorted(annotations)
            for name in sorted(annotations[folder])]


def export_pairs(dataroot: str, out_csv: str, seed: int = 49) -> int:
    """Random pairing, one pair per image (reference
    PoseTransfer_convert_RHD.py:17-45)."""
    images = _color_images(load_annotations(dataroot))
    rng = random.Random(seed)
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["from", "to"])
        for _ in range(len(images)):
            a = rng.randrange(len(images))
            b = rng.randrange(len(images))
            writer.writerow([os.path.join(*images[a]),
                             os.path.join(*images[b])])
    return len(images)


def export_keypoints(dataroot: str, out_csv: str) -> int:
    """The ``name:keypoints_y:keypoints_x`` CSV of the pose-map generator
    (the input of reference tool/generate_pose_map_*.py), each name with
    its extension."""
    annotations = load_annotations(dataroot)
    images = _color_images(annotations)
    with open(out_csv, "w") as f:
        f.write("name:keypoints_y:keypoints_x\n")
        for folder, name in images:
            uv = np.asarray(annotations[folder][name]["uv_coord"])
            ys = json.dumps([round(float(v), 3) for v in uv[:, 1]])
            xs = json.dumps([round(float(v), 3) for v in uv[:, 0]])
            f.write(f"{os.path.join(folder, name)}:{ys}:{xs}\n")
    return len(images)


def export_pix2pixhd(dataroot: str, dst: str, size: int = 256,
                     device="cuda", batch: int = 64) -> int:
    """Label maps and image copies (the role of reference
    pix2pixHD_convert_synthetic_hands.py): the label is the depth-ordered
    jointsmap, its bone colour values the label ids.  The jointsmaps of
    ``batch`` images are rasterized in one call on ``device``."""
    from PIL import Image

    device = check_device(device)
    annotations = load_annotations(dataroot)
    images = _color_images(annotations)
    img_dir = os.path.join(dst, "train_img")
    lbl_dir = os.path.join(dst, "train_label")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)
    for start in range(0, len(images), batch):
        chunk = images[start:start + batch]
        annos = [annotations[folder][name] for folder, name in chunk]
        uv = np.stack([np.asarray(a["uv_coord"], np.float32) for a in annos])
        z = np.stack([np.asarray(a["depth"], np.float32) for a in annos])
        labels = generate_jointsmap(torch.from_numpy(uv).to(device),
                                    torch.from_numpy(z).to(device),
                                    size, size).cpu().numpy()
        for (folder, name), label in zip(chunk, labels):
            flat = f"{folder}_{name}"
            Image.fromarray(label.astype(np.uint8)).save(
                os.path.join(lbl_dir, flat))
            src_img = os.path.join(dataroot, folder, name)
            if os.path.isfile(src_img):
                Image.open(src_img).convert("RGB").save(
                    os.path.join(img_dir, flat))
    return len(images)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("mode", choices=["pairs", "keypoints", "pix2pixhd"])
    parser.add_argument("dataroot")
    parser.add_argument("out")
    parser.add_argument("--seed", type=int, default=49)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--device", default="cuda",
                        help="where pix2pixhd rasterizes its labels")
    parser.add_argument("--batch", type=int, default=64,
                        help="jointsmaps per rasterizer call (pix2pixhd)")
    args = parser.parse_args(argv)
    if args.mode == "pairs":
        n = export_pairs(args.dataroot, args.out, args.seed)
    elif args.mode == "keypoints":
        n = export_keypoints(args.dataroot, args.out)
    else:
        n = export_pix2pixhd(args.dataroot, args.out, args.size, args.device,
                             args.batch)
    print(f"{args.mode}: exported {n} entries to {args.out}")
    return n


if __name__ == "__main__":
    main()
