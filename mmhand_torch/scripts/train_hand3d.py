"""hand3d subnet training with the PyTorch port (counterpart of
scripts/train_hand3d.py; reference
hand_pose_estimators/CVPR2020_hand3d/training_handsegnet.py,
training_posenet.py:28-120, training_lifting.py): staged-LR Adam on one
subnet at a time, from the packed binary GAN DB that
``mmhand_torch.scripts.create_hand3d_db`` writes, or from synthetic records.

    python -m mmhand_torch.scripts.train_hand3d --net posenet --bin db.bin \\
        --name h3d --checkpoints_dir ckpt [--max_iter 30000]
    python -m mmhand_torch.scripts.train_hand3d --net lifting \\
        --variant proposed ...

The host reads and stacks the records; every derivation (palm coordinates,
the hand side, the canonical and relative trafos, the crop, the
scoremaps) runs on ``--device`` (default cuda) in ``derive_batch``.  The
state goes to ``<checkpoints_dir>/<name>_<net>/state_latest.pt`` every
snapshot_freq iterations and at the end; ``--continue_train`` resumes from
it.  As in mmhand_tpu, the record indices and the pipeline's noise restart
from --seed on a resume.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from mmhand_torch.data.hand3d_binary import Hand3dBinaryDataset
from mmhand_torch.hand3d import (
    Hand3DSystem,
    PipelineConfig,
    derive_batch,
    make_hand3d_train_step,
)
from mmhand_torch.hand3d.system import NETS
from mmhand_torch.models.hand3d import LIFTING_VARIANTS
from mmhand_torch.utils.checkpoint import CheckpointManager


def records_to_pipeline_batch(records) -> dict:
    """Stack ``read_record`` dicts into the pipeline's raw-record arrays."""
    return {
        "keypoint_xyz": np.stack([r["xyz"] for r in records]),
        "keypoint_uv": np.stack([r["uv"] for r in records]),
        "cam_mat": np.stack([r["K"] for r in records]),
        "image": np.stack([r["image"] for r in records]),
        "hand_parts": np.stack([r["mask"] for r in records]),
        "keypoint_vis": np.stack([r["visible"] for r in records]) > 0,
    }


def synthetic_records(batch: int, size: int = 64, seed: int = 0) -> list:
    """Random records shaped like the GAN DB, each with a block of left-hand
    pixels in its mask (the smoke and test path)."""
    rng = np.random.RandomState(seed)
    recs = []
    for _ in range(batch):
        mask = np.zeros((size, size), np.uint8)
        mask[size // 4:size // 2, size // 4:size // 2] = 5  # left hand px
        recs.append({
            "xyz": rng.normal(size=(42, 3)).astype(np.float32),
            "uv": rng.uniform(5, size - 5, (42, 2)).astype(np.float32),
            "K": np.eye(3, dtype=np.float32) * size,
            "image": rng.randint(0, 255, (size, size, 3), np.uint8),
            "mask": mask,
            "visible": np.ones(42, np.uint8),
        })
    return recs


def pipeline_config_for(net: str, size, crop_size: int) -> PipelineConfig:
    """The reader flags of each reference training script."""
    if net == "handsegnet":
        # training_handsegnet.py:41-43: full frames, no crop
        return PipelineConfig(image_size=size, use_wrist_coord=False)
    if net == "posenet":
        # training_posenet.py:41-43
        return PipelineConfig(
            image_size=size, use_wrist_coord=False, hand_crop=False,
            coord_uv_noise=True, crop_center_noise=True)
    # training_lifting.py:45-47: ground-truth scoremaps of noisy crops
    return PipelineConfig(
        image_size=size, crop_size=crop_size, use_wrist_coord=False,
        hand_crop=True, coord_uv_noise=True, crop_center_noise=True,
        crop_offset_noise=True, crop_scale_noise=True)


@dataclasses.dataclass
class Hand3DTrainResult:
    system: Hand3DSystem
    # the loss of each iteration this run took
    losses: list


def main(argv=None) -> Hand3DTrainResult:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--net", choices=NETS, required=True)
    p.add_argument("--variant", default="proposed", choices=LIFTING_VARIANTS)
    p.add_argument("--bin", default=None,
                   help="packed GAN DB (create_hand3d_db); synthetic "
                        "records when omitted")
    p.add_argument("--name", default="hand3d")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--max_iter", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda was asked for, but torch sees no "
                           "CUDA device")

    system = Hand3DSystem(net=args.net, variant=args.variant,
                          crop_size=args.crop_size, device=device,
                          seed=args.seed)
    para = dict(system.train_para)
    if args.max_iter is not None:
        para["max_iter"] = args.max_iter
    size = (args.image_size, args.image_size)
    cfg = pipeline_config_for(args.net, size, args.crop_size)

    if args.bin:
        ds = Hand3dBinaryDataset(args.bin, args.image_size, args.image_size)
        n = len(ds)
        get = lambda idx: [ds[i % n] for i in idx]  # noqa: E731
    else:
        recs = synthetic_records(args.batch_size * 4, args.image_size,
                                 args.seed)
        n = len(recs)
        get = lambda idx: [recs[i % n] for i in idx]  # noqa: E731

    ckpt = CheckpointManager(args.checkpoints_dir, f"{args.name}_{args.net}")
    if args.continue_train and ckpt.has("latest"):
        fresh = ckpt.restore(system, "latest")
        print(f"resumed at step {system.step}" + (
            f" from a state mmhand_tpu trained: the dropout stream "
            f"starts fresh from --seed {args.seed}" if fresh else ""))

    step = make_hand3d_train_step(system)
    rng = np.random.RandomState(args.seed)
    noise = torch.Generator().manual_seed(args.seed + 1)
    losses = []
    t0 = time.time()
    for it in range(system.step, para["max_iter"]):
        idx = rng.randint(0, n, args.batch_size)
        batch = derive_batch(records_to_pipeline_batch(get(idx)), cfg, noise,
                             device)
        losses.append(float(step(batch)))
        if it % para["show_loss_freq"] == 0:
            print(f"Iteration {it}\t Loss {losses[-1]:.3e}\t "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if it and it % para["snapshot_freq"] == 0:
            ckpt.save(system, "latest")
            print("Saved a snapshot.", flush=True)
    ckpt.save(system, "latest")
    final = f"; final loss {losses[-1]:.3e}" if losses else ""
    print(f"Training finished after {para['max_iter']} iterations{final}")
    return Hand3DTrainResult(system, losses)


if __name__ == "__main__":
    main()
