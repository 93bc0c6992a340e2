"""Pack a crop tree, or the images generated for it, into the hand3d
binary GAN DB (counterpart of scripts/create_hand3d_db.py; reference
hand_pose_estimators/CVPR2020_hand3d/data/create_GAN_DB.py), so the
ColorHandPose3D stack (``mmhand_torch.scripts.train_hand3d``) trains on
them.

    python -m mmhand_torch.scripts.create_hand3d_db \\
        --dataroot /data/rhd_crop --images /data/MM-Hand_rhd_crop \\
        --out gan_train.bin

Each image under --images (the dataroot by default) that the tree's
annotation.pickle names becomes one record with the annotation's uv, xyz
and K; an annotated image that is missing there is skipped.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from mmhand_torch.data.annotations import load_annotations
from mmhand_torch.data.hand3d_binary import write_gan_db
from mmhand_torch.hpe.data import _read_rgb


def samples(annotations: dict, images_root: str):
    """The records' fields, folder by folder ("color" alone where the tree
    has it), names in sorted order."""
    folders = (["color"] if "color" in annotations
               else sorted(annotations.keys()))
    for folder in folders:
        for name, anno in sorted(annotations[folder].items()):
            path = os.path.join(images_root, folder, name)
            if not os.path.isfile(path):
                continue
            yield {"image": _read_rgb(path),
                   "uv": np.asarray(anno["uv_coord"], np.float32),
                   "xyz": np.asarray(anno["xyz"], np.float32),
                   "K": np.asarray(anno.get("K", anno.get("k")),
                                   np.float32)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataroot", required=True,
                        help="crop tree with annotation.pickle")
    parser.add_argument("--images", default=None,
                        help="image tree (defaults to dataroot, e.g. the "
                             "aug output dir)")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    start = time.perf_counter()
    n = write_gan_db(args.out, samples(load_annotations(args.dataroot),
                                       args.images or args.dataroot))
    seconds = time.perf_counter() - start
    print(f"wrote {n} records to {args.out} in {seconds:.3f} s")
    return n


if __name__ == "__main__":
    main()
