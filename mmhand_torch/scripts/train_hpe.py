"""Downstream HPE training on real/synthetic mixtures with the PyTorch port
(counterpart of scripts/train_hpe.py; reference
hand_pose_estimators/CVPR2020_hpm3d/train.py:28-92).

    python -m mmhand_torch.scripts.train_hpe --dataset RHD \\
        --dataroot /data/rhd_crop --augmentation_ratio 0.8 \\
        --augmentation_method MM-Hand --name hpe_rhd_08 --batchSize 16 \\
        --niter 90

Per epoch: the LR of the epoch's schedule (lambda, step or plateau; plateau
reads the epoch's mean ``mse``, or ``lz`` for ``--model hpm3d``), the
(seed, epoch)-keyed permutation of the items, the train step on each batch,
the reference's print cadence; the state is saved every --save_epoch_freq
epochs and at the end, and every 5 epochs the dataset's curriculum hook runs
(reference train.py:89-91).  ``--continue_train`` restores
``state_<--which_epoch>.pt`` when it exists; the epochs restart at
--epoch_count, as in mmhand_tpu.  ``--from_bin`` trains from a hand3d packed
binary GAN DB instead of a crop tree.

It trains on ``--device`` (default cuda) and never moves to another device
on its own.  ``--multihost`` trains data-parallel, one process per device,
as launched by torchrun (NCCL on ``cuda:LOCAL_RANK``, or gloo with
``--device cpu``); --batchSize is the global batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from mmhand_torch.config import Config, add_cli_args, from_cli_args
from mmhand_torch.data.loader import epoch_permutation, host_shard
from mmhand_torch.hpe import (
    HPEMixDataset,
    HPESystem,
    make_hpe_prepare_batch,
    make_hpe_train_step,
)
from mmhand_torch.hpe.data import BinDBDataset
from mmhand_torch.parallel import init_distributed
from mmhand_torch.train.step import LRSchedule
from mmhand_torch.utils.checkpoint import CheckpointManager
from mmhand_torch.utils.logging import Visualizer

CURRICULUM_EVERY = 5  # reference train.py:89-91


@dataclasses.dataclass
class HPETrainResult:
    system: HPESystem
    steps: int
    last_metrics: dict
    # images per second over all ranks after the first step, which pays
    # cuDNN's warm-up; None when the run took one step
    images_per_sec: Optional[float]
    # images this rank read from the augmentation directory
    augmented_reads: int


def main(argv=None) -> HPETrainResult:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_cli_args(parser)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--model", default="hpm",
                        choices=("hpm", "hpm2d", "hpm3d"),
                        help="trainer variant (reference models/__init__.py:"
                             "55-67): joint 2d+3d, 2d-only, or 3d-only")
    parser.add_argument("--from_bin", type=str, default=None,
                        help="train from a hand3d packed binary GAN DB "
                             "instead of a crop tree")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on")
    parser.add_argument("--multihost", action="store_true",
                        help="one rank of a torchrun launch: data-parallel "
                             "over torch.distributed")
    args = parser.parse_args(argv)
    cfg = from_cli_args(args, Config())
    device = args.device
    if args.multihost:
        device = init_distributed(args.device)
    try:
        result = train_hpe(cfg, max_steps=args.max_steps, epochs=args.epochs,
                           from_bin=args.from_bin, variant=args.model,
                           device=device, distributed=args.multihost)
    finally:
        if args.multihost:
            dist.destroy_process_group()
    if result.system.rank == 0:
        shown = " ".join(f"{k}={v:.4f}" for k, v in
                         result.last_metrics.items())
        rate = ("" if result.images_per_sec is None else
                f"; {result.images_per_sec:.2f} images/s after the first "
                f"step")
        print(f"done: {result.steps} steps, {shown}{rate}; "
              f"{result.augmented_reads} augmented images read")
    return result


def train_hpe(cfg: Config, max_steps: Optional[int] = None,
              epochs: Optional[int] = None, from_bin: Optional[str] = None,
              variant: str = "hpm", device="cuda",
              distributed: bool = False) -> HPETrainResult:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda was asked for, but torch sees no "
                           "CUDA device")
    run = cfg.run
    system = HPESystem(cfg, variant, device, distributed=distributed)
    master = system.rank == 0
    step = make_hpe_train_step(system)
    prepare = make_hpe_prepare_batch(device=device)
    dataset = (BinDBDataset(from_bin, size=cfg.model.fine_size) if from_bin
               else HPEMixDataset(cfg, is_train=True))
    ckpt = CheckpointManager(run.checkpoints_dir, run.name)
    sched = LRSchedule(cfg)
    sched_path = os.path.join(run.checkpoints_dir, run.name, "lr_sched.json")
    if run.continue_train and ckpt.has(run.which_epoch):
        ckpt.restore(system, run.which_epoch)
        if os.path.exists(sched_path):  # plateau state sidecar
            with open(sched_path) as fh:
                sched.load_state_dict(json.load(fh))
    vis = Visualizer(run.checkpoints_dir, run.name, master=master)
    vis.save_options(cfg)
    plateau = cfg.optim.lr_policy == "plateau"

    # per-rank batch (reference options/base_options.py:178)
    bsz = max(1, cfg.data.batch_size // system.world)
    epochs = epochs if epochs is not None else (
        cfg.optim.niter + cfg.optim.niter_decay)
    n = len(dataset)
    if cfg.data.max_dataset_size:
        n = min(n, cfg.data.max_dataset_size)
    total = 0
    metrics: dict = {}
    first = None  # clock when the first step had finished
    epoch_metric = None

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def result() -> HPETrainResult:
        """The run so far; the clock stops before any checkpoint write."""
        sync()
        rate = None
        if first is not None and total > 1:
            rate = ((total - 1) * bsz * system.world
                    / (time.perf_counter() - first))
        return HPETrainResult(
            system, total, {k: float(v) for k, v in metrics.items()}, rate,
            getattr(dataset, "augmented_reads", 0))

    for epoch in range(cfg.optim.epoch_count, epochs + 1):
        lr = sched.epoch_lr(epoch - cfg.optim.epoch_count, epoch_metric)
        if plateau and master:
            with open(sched_path, "w") as fh:
                json.dump(sched.state_dict(), fh)
        order = host_shard(epoch_permutation(n, cfg.data.seed, epoch),
                           system.rank, system.world)
        # the plateau input: the variant's primary objective, device
        # scalars fetched once per epoch
        epoch_losses = []
        for i in range(len(order) // bsz):
            t0 = time.time()
            raw = dataset.batch(order[i * bsz:(i + 1) * bsz])
            metrics = step(prepare(raw), lr)
            epoch_losses.append(metrics.get("mse", metrics.get("lz")))
            total += 1
            if first is None:
                sync()
                first = time.perf_counter()
            if total % run.print_freq == 0:
                vis.print_current_errors(
                    epoch, total, {k: float(v) for k, v in metrics.items()},
                    (time.time() - t0) / bsz)
            if max_steps and total >= max_steps:
                done = result()
                ckpt.save(system, "latest")
                return done
        if epoch_losses:
            epoch_metric = float(torch.stack(epoch_losses).double().mean())
        if epoch % run.save_epoch_freq == 0:
            ckpt.save(system, str(epoch))
            ckpt.save(system, "latest")
        if epoch % CURRICULUM_EVERY == 0 and hasattr(dataset,
                                                      "update_parameters"):
            dataset.update_parameters()  # reference train.py:89-91
    done = result()
    ckpt.save(system, "latest")
    return done


if __name__ == "__main__":
    main()
