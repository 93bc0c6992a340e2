"""Training loop on one device (counterpart of mmhand_tpu/train/loop.py:70-209;
reference train.py:10-65).

Per epoch: the LR of the epoch's schedule, then ``HostLoader`` ->
``make_prepare_batch`` on the device -> the train step, with the reference's
print, latest-save and epoch-save cadences and ``max_steps``.  The epoch order
is a permutation keyed by (seed, epoch), the ``DistributedSampler.set_epoch``
equivalent (reference train.py:52-53).  Checkpoints are the three networks'
state_dicts in the reference naming (``utils.checkpoint``).

Not here yet: a mesh or several hosts, the visualizer snapshot, and resuming
the optimizer and pool state (``--continue_train``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from mmhand_torch.config import Config
from mmhand_torch.data import HostLoader, build_dataset, make_prepare_batch
from mmhand_torch.train.state import MMHandSystem, build_system
from mmhand_torch.train.step import LRSchedule, make_train_step
from mmhand_torch.utils.checkpoint import save_network


@dataclasses.dataclass
class TrainResult:
    system: MMHandSystem
    steps: int
    last_metrics: dict
    # images per second after the first step, which pays cuDNN's warm-up;
    # None when the run took one step
    images_per_sec: Optional[float]


def save_networks(system: MMHandSystem, label: str) -> None:
    """``<label>_net_{netG,netD_PB,netD_PP}.pth`` under the run's directory."""
    run = system.config.run
    for net, module in (("netG", system.generator), ("netD_PB", system.d_pb),
                        ("netD_PP", system.d_pp)):
        save_network(module, run.checkpoints_dir, run.name, label, net)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: Config, *, device="cuda", max_steps: Optional[int] = None,
          vgg_npz: Optional[str] = None,
          total_epochs: Optional[int] = None) -> TrainResult:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda was asked for, but torch sees no "
                           "CUDA device")
    if cfg.run.continue_train:
        raise NotImplementedError("--continue_train (optimizer and pool "
                                  "state) is not ported to mmhand_torch yet")
    system = build_system(cfg, device, vgg_npz=vgg_npz)
    step_fn = make_train_step(system)
    sched = LRSchedule(cfg)
    loader = HostLoader(build_dataset(cfg), cfg.data.batch_size,
                        seed=cfg.data.seed, shuffle=not cfg.data.serial_batches,
                        num_threads=cfg.data.n_threads,
                        max_items=cfg.data.max_dataset_size)
    prepare = make_prepare_batch(cfg.data.sigma, device)
    run = cfg.run

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
            rate = ((total_steps - 1) * cfg.data.batch_size
                    / (time.perf_counter() - first))
        return TrainResult(system, total_steps,
                           {k: float(v) for k, v in metrics.items()}, rate)

    for epoch in range(cfg.optim.epoch_count, epochs_end + 1):
        lr = sched.epoch_lr(epoch - cfg.optim.epoch_count, epoch_metric)
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
                # reference util/visualizer.py:116-123 format
                errors = {k: float(v) for k, v in metrics.items()}
                message = (f"(epoch: {epoch}, iters: {total_steps}, time: "
                           f"{(time.time() - t0) / cfg.data.batch_size:.3f}) ")
                print(message + "".join(f"{k}: {v:.3f} "
                                        for k, v in errors.items()))
            if total_steps % run.save_latest_freq == 0:
                save_networks(system, "latest")
            if max_steps and total_steps >= max_steps:
                done = result()
                save_networks(system, "latest")
                return done

        if plateau and epoch_losses:
            epoch_metric = float(torch.stack(epoch_losses).double().mean())
        if epoch % run.save_epoch_freq == 0:
            save_networks(system, str(epoch))
            save_networks(system, "latest")
        print(f"End of epoch {epoch} / {epochs_end} \t"
              f"Time Taken: {time.time() - epoch_start:.0f} sec")

    done = result()
    save_networks(system, "latest")
    return done
