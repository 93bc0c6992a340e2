"""Pose-map rendering with the PyTorch port (counterpart of
scripts/generate_pose_maps.py; reference tool/generate_pose_map_{RHD,STB,
MHP,GANerated,realhand}.py): a ``name:keypoints_y:keypoints_x`` CSV to one
21-channel Gaussian ``<SAVE_PATH>/<name>.npy`` per row, the prerendered maps
that ``--dataset MMHand`` reads from ``<poseroot>/<phase>P``.  Host work
only, so it takes no --device.

    python -m mmhand_torch.scripts.generate_pose_maps annotations.csv \\
        /data/pose/trainP [--size 256 256] [--sigma 6]
"""

from __future__ import annotations

import argparse

from mmhand_torch.data.csv_dataset import compute_pose_maps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("annotations_csv")
    parser.add_argument("save_path")
    parser.add_argument("--size", type=int, nargs=2, default=[256, 256])
    parser.add_argument("--sigma", type=float, default=6.0)
    parser.add_argument("--sep", default=":")
    args = parser.parse_args(argv)
    n = compute_pose_maps(args.annotations_csv, args.save_path,
                          tuple(args.size), args.sigma, args.sep)
    print(f"rendered {n} pose maps to {args.save_path}")
    return n


if __name__ == "__main__":
    main()
