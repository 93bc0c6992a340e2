"""Training loop (counterpart of mmhand_tpu/train/loop.py:70-221; reference
train.py:10-65).

Per epoch: the LR of the epoch's schedule, then ``HostLoader`` ->
``make_prepare_batch`` on the device -> the train step, with the reference's
print (``Visualizer``: the console, ``loss_log.txt`` and, with
--display_id > 0, the live plot), snapshot, latest-save and epoch-save
cadences and ``max_steps``.  The epoch order is a permutation keyed by
(seed, epoch), the ``DistributedSampler.set_epoch`` equivalent (reference
train.py:52-53).

Every save writes the whole train state (``CheckpointManager``,
``state_<label>.pt``) and the three networks' ``.pth`` files in the
reference naming.  ``--continue_train`` restores the state labeled
--which_epoch when it exists, else starts fresh, as mmhand_tpu; the plateau
schedule's state lives in the ``lr_sched.json`` sidecar.  As in mmhand_tpu,
a resumed run starts its epochs at --epoch_count.

``distributed``: this process is one rank of the initialized
torch.distributed group.  It trains on ``batch_size // world`` items of
its own shard of every epoch; only rank 0 prints and writes, every rank
takes part in the gathers of a save.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import torch

from mmhand_torch.config import Config
from mmhand_torch.data import HostLoader, build_dataset, make_prepare_batch
from mmhand_torch.train.state import MMHandSystem, build_system
from mmhand_torch.train.step import LRSchedule, make_eval_step, make_train_step
from mmhand_torch.utils.checkpoint import CheckpointManager, save_network
from mmhand_torch.utils.logging import Visualizer
from mmhand_torch.utils.visualize import seven_tile_strip


@dataclasses.dataclass
class TrainResult:
    system: MMHandSystem
    steps: int
    last_metrics: dict
    # images per second over all ranks after the first step, which pays
    # cuDNN's warm-up; None when the run took one step
    images_per_sec: Optional[float]


def save_networks(system: MMHandSystem, label: str) -> None:
    """``<label>_net_{netG,netD_PB,netD_PP}.pth`` under the run's directory."""
    run = system.config.run
    for net, module in (("netG", system.generator), ("netD_PB", system.d_pb),
                        ("netD_PP", system.d_pp)):
        save_network(module, run.checkpoints_dir, run.name, label, net)


def save_all(ckpt: CheckpointManager, system: MMHandSystem, label: str) -> None:
    """The train state on every rank's call; the ``.pth`` files on rank 0."""
    ckpt.save(system, label)
    if system.rank == 0:
        save_networks(system, label)


def _save_snapshot(vis: Visualizer, system: MMHandSystem, batch: dict,
                   name: str) -> None:
    """The [H1, P1, D1, H2, P2, D2, fake] strip of the batch's first item,
    the fake from the generator in eval mode (reference MMHandModel.py:
    343-369)."""
    one = {k: v[:1] for k, v in batch.items()}
    fake = make_eval_step(system.generator)(one)
    host = {k: v.cpu().numpy() for k, v in one.items()}
    vis.save_image(seven_tile_strip(host["H1"], host["P1"], host["D1"],
                                    host["H2"], host["P2"], host["D2"],
                                    fake.cpu().numpy()), name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_loader(cfg: Config, rank: int = 0, world: int = 1) -> HostLoader:
    """Rank ``rank``'s loader of the configured dataset: its shard of every
    epoch's order, at the per-rank batch (reference
    options/base_options.py:178)."""
    return HostLoader(build_dataset(cfg), max(1, cfg.data.batch_size // world),
                      seed=cfg.data.seed, host_id=rank, num_hosts=world,
                      shuffle=not cfg.data.serial_batches,
                      num_threads=cfg.data.n_threads,
                      max_items=cfg.data.max_dataset_size)


def train(cfg: Config, *, device="cuda", max_steps: Optional[int] = None,
          vgg_npz: Optional[str] = None, total_epochs: Optional[int] = None,
          distributed: bool = False) -> TrainResult:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda was asked for, but torch sees no "
                           "CUDA device")
    system = build_system(cfg, device, vgg_npz=vgg_npz, distributed=distributed)
    run = cfg.run
    master = system.rank == 0
    ckpt = CheckpointManager(run.checkpoints_dir, run.name)
    sched = LRSchedule(cfg)
    sched_path = os.path.join(run.checkpoints_dir, run.name, "lr_sched.json")
    resume = run.continue_train and ckpt.has(run.which_epoch)
    if resume:
        ckpt.restore(system, run.which_epoch)
        if os.path.exists(sched_path):  # plateau state sidecar
            with open(sched_path) as fh:
                sched.load_state_dict(json.load(fh))
    step_fn = make_train_step(system)
    vis = Visualizer(run.checkpoints_dir, run.name, master=master)
    vis.save_options(cfg)

    loader = make_loader(cfg, system.rank, system.world)
    local_bsz = loader.batch_size
    prepare = make_prepare_batch(cfg.data.sigma, device)

    epochs_end = total_epochs if total_epochs is not None else (
        cfg.optim.niter + cfg.optim.niter_decay)
    total_steps = 0
    metrics: dict = {}
    first = None  # clock when the first step had finished
    plateau = cfg.optim.lr_policy == "plateau"
    epoch_metric = None  # last epoch's mean G objective (plateau input)

    def result() -> TrainResult:
        """The run so far; the clock stops before any checkpoint write."""
        _sync(device)
        rate = None
        if first is not None and total_steps > 1:
            rate = ((total_steps - 1) * local_bsz * system.world
                    / (time.perf_counter() - first))
        return TrainResult(system, total_steps,
                           {k: float(v) for k, v in metrics.items()}, rate)

    for epoch in range(cfg.optim.epoch_count, epochs_end + 1):
        lr = sched.epoch_lr(epoch - cfg.optim.epoch_count, epoch_metric)
        if plateau and master:
            with open(sched_path, "w") as fh:
                json.dump(sched.state_dict(), fh)
        epoch_losses = []  # device scalars, fetched once per epoch
        epoch_start = time.time()
        for raw in loader.epoch(epoch):
            t0 = time.time()
            batch = prepare({k: v for k, v in raw.items()
                             if not k.endswith("paths")})
            metrics = step_fn(batch, lr)
            total_steps += 1
            if first is None:
                _sync(device)
                first = time.perf_counter()
            if plateau:
                epoch_losses.append(
                    metrics["pair_L1loss"] + metrics["pair_GANloss"])
            if total_steps % run.print_freq == 0:
                errors = {k: float(v) for k, v in metrics.items()}
                vis.print_current_errors(epoch, total_steps, errors,
                                         (time.time() - t0) / local_bsz)
                if run.display_id > 0:  # live chart (reference
                    # train.py:41-44 plots at print_freq when display_id>0)
                    spe = max(1, loader.steps_per_epoch())
                    vis.plot_current_errors(
                        epoch, (total_steps % spe) / spe, errors)
            if (total_steps % run.display_freq == 0 and master
                    and system.world == 1):  # the snapshot fetches to the host
                _save_snapshot(vis, system, batch,
                               f"epoch{epoch:03d}_step{total_steps}.png")
            if total_steps % run.save_latest_freq == 0:
                save_all(ckpt, system, "latest")
            if max_steps and total_steps >= max_steps:
                done = result()
                save_all(ckpt, system, "latest")
                return done

        if plateau and epoch_losses:
            epoch_metric = float(torch.stack(epoch_losses).double().mean())
        if epoch % run.save_epoch_freq == 0:
            save_all(ckpt, system, str(epoch))
            save_all(ckpt, system, "latest")
        if master:
            print(f"End of epoch {epoch} / {epochs_end} \t"
                  f"Time Taken: {time.time() - epoch_start:.0f} sec")

    done = result()
    save_all(ckpt, system, "latest")
    return done
