"""Downstream hand-pose-estimator trainer of the augmentation study
(counterpart of mmhand_tpu/hpe/system.py; reference
hand_pose_estimators/CVPR2020_hpm3d/models/hpm_model.py:25-199).

* two networks, Hpm2d (image -> 6-stage heatmaps) and Hpm3d (ground-truth
  heatmaps -> 21 z values), with two Adam optimizers, betas (0.5, 0.999),
  eps 1e-8, the learning rate set by the caller for each step;
* loss_mse = the sum over the 6 stage outputs of the MSE against the
  sigma-5 ground-truth heatmaps, masked by the instance weight, x1000
  (reference Criterion :168-173);
* loss_lz = SmoothL1 on z, instance-weight masked (:108-115), x10 for the
  ``hpm3d`` variant alone (hpm3d_model.py:105).

The instance weight masks the samples whose image was replaced by noise in
the method "None" ablation.  Torch's reference indexes ``x[iw==1]``; here,
as in mmhand_tpu, the same mean is taken with static shapes:
sum(iw * per_sample) / max(1, sum(iw)).

The nets compute under ``torch.autocast`` in PrecisionConfig.compute_dtype
(bf16 by default, mmhand_tpu's ``dtype=jnp.bfloat16``) with f32 parameters,
or in plain f32.  Their weights are drawn as flax's defaults draw them
(lecun-normal kernels, zero biases) from ``cfg.data.seed``.  Over several
ranks each net's gradients are averaged in one all-reduce and the metrics
are averaged, as mmhand_tpu's ``pmean``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from mmhand_torch.config import Config
from mmhand_torch.models.cpm import Hpm2d, Hpm3d
from mmhand_torch.models.layers import init_lecun_normal
from mmhand_torch.parallel.sharding import mean_metrics
from mmhand_torch.train.state import (
    backward_and_step,
    compute_dtype,
    load_adam_state_dict,
    make_adam,
    set_lr,
    step_span,
)
from mmhand_torch.utils import trace

STAGE_LOSS_SCALE = 1000.0  # reference hpm_model.py:173
VARIANTS = ("hpm", "hpm2d", "hpm3d")


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch SmoothL1Loss (beta=1) elementwise: 0.5 x^2 if |x| < 1 else
    |x| - 0.5."""
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def _masked_mean(per_sample: torch.Tensor, weight: torch.Tensor
                 ) -> torch.Tensor:
    """Mean over the samples of weight 1 (the static-shape ``x[iw==1]``)."""
    w = weight.to(torch.float32)
    return (per_sample * w).sum() / torch.clamp(w.sum(), min=1.0)


def _place(net: nn.Module, device) -> nn.Module:
    return net.to(device=device, memory_format=torch.channels_last)


def load_hpe_nets(path: str, size: int, device="cuda"
                  ) -> tuple[Optional[Hpm2d], Optional[Hpm3d]]:
    """The Hpm2d and Hpm3d of a ``state_<label>.pt`` on ``device``, in eval
    mode; None for a net the checkpoint's variant does not train."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    nets = []
    for name, net in (("hpm2d", Hpm2d()), ("hpm3d", Hpm3d(size=size))):
        if state[name] is None:
            nets.append(None)
            continue
        net.load_state_dict(state[name])
        nets.append(_place(net, device).eval())
    return nets[0], nets[1]


class HPESystem:
    """The HPE nets and optimizers of ``variant`` on ``device``
    (reference models/__init__.py:55-67):

    * ``hpm``: the joint 2d + 3d trainer (hpm_model.py:25-135; the default,
      the only one the reference's own scripts use, train-hpm.sh:9);
    * ``hpm2d``: Hpm2d alone with the staged criterion (hpm2d_model.py:
      25-112; the reference's variant crashes on its first backward, the
      port trains the policy the flag promises, as mmhand_tpu);
    * ``hpm3d``: Hpm3d alone, built at ``fine_size``, SmoothL1 x10
      (hpm3d_model.py:98-107).

    ``distributed``: this process is one rank of the initialized
    torch.distributed group.  ``state_dict``/``load_state_dict`` hold the
    nets, the Adams and the step, for ``CheckpointManager``."""

    def __init__(self, cfg: Config, variant: str = "hpm", device="cuda",
                 distributed: bool = False):
        if variant not in VARIANTS:
            raise ValueError(f"unknown HPE model variant [{variant}]")
        self.config = cfg
        self.variant = variant
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype(cfg.precision.compute_dtype)
        self.distributed = distributed
        self.rank, self.world = ((dist.get_rank(), dist.get_world_size())
                                 if distributed else (0, 1))
        self.step = 0
        # one stream on the CPU for both nets, as build_generator draws
        gen = torch.Generator().manual_seed(cfg.data.seed)
        self.hpm2d = self.hpm3d = self.opt2d = self.opt3d = None
        if variant in ("hpm", "hpm2d"):
            with trace.timed("setup.init_weights_s"):
                self.hpm2d = _place(init_lecun_normal(Hpm2d(), gen),
                                    self.device)
            self.opt2d = make_adam(self.hpm2d, cfg)
        if variant in ("hpm", "hpm3d"):
            with trace.timed("setup.init_weights_s"):
                self.hpm3d = _place(init_lecun_normal(
                    Hpm3d(size=cfg.model.fine_size), gen), self.device)
            self.opt3d = make_adam(self.hpm3d, cfg)

    def autocast(self):
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

    def state_dict(self) -> dict:
        """The train state; nothing differs between ranks (``"rank"`` is
        empty)."""
        d = {"variant": self.variant, "step": self.step, "rank": {}}
        for name in ("hpm2d", "hpm3d", "opt2d", "opt3d"):
            part = getattr(self, name)
            d[name] = None if part is None else part.state_dict()
        return d

    def load_state_dict(self, d: dict) -> None:
        if d["variant"] != self.variant:
            raise ValueError(f"the checkpoint holds variant [{d['variant']}],"
                             f" this system [{self.variant}]")
        for name in ("hpm2d", "hpm3d"):
            if getattr(self, name) is not None:
                getattr(self, name).load_state_dict(d[name])
        for name in ("opt2d", "opt3d"):
            if getattr(self, name) is not None:
                load_adam_state_dict(getattr(self, name), d[name])
        self.step = int(d["step"])


def _update(system: HPESystem, net: nn.Module, opt: torch.optim.Adam,
            loss: torch.Tensor, lr: float) -> None:
    set_lr(opt, lr)
    opt.zero_grad(set_to_none=True)
    backward_and_step(net, opt, loss, system.device, system.distributed)


def make_hpe_train_step(system: HPESystem):
    """step(batch, lr) -> metrics.

    batch: {image (B, S, S, 3) in [-1, 1], heatmaps (B, S, S, 21) sigma-5
    ground truth, z (B, 21) depth / 0.7, weight (B,) 0/1} on the system's
    device.  metrics: {"mse"} and/or {"lz"} as 0-d f32 tensors, averaged
    over the ranks.  Each call begins a step (``utils.trace``) and is the
    host span ``step``; each net's update is a ``backward`` and an ``adam``
    span on the device."""
    variant = system.variant
    # hpm3d single-net quirk: SmoothL1 x10 (reference hpm3d_model.py:105);
    # the joint trainer applies it unscaled (hpm_model.py:108-115)
    lz_scale = 10.0 if variant == "hpm3d" else 1.0

    def train_step(batch: dict, lr: float) -> dict:
        with step_span():
            return _train_step(batch, lr)

    def _train_step(batch: dict, lr: float) -> dict:
        image, heat = batch["image"], batch["heatmaps"]
        z, w = batch["z"], batch["weight"]
        metrics = {}
        if system.hpm2d is not None:
            system.hpm2d.train()
            with system.autocast():
                stages = system.hpm2d(image)
            loss = 0.0
            for s in stages:
                per = ((s.float() - heat) ** 2).mean(dim=(1, 2, 3))
                loss = loss + _masked_mean(per, w)
            loss = loss * STAGE_LOSS_SCALE
            _update(system, system.hpm2d, system.opt2d, loss, lr)
            metrics["mse"] = loss.detach()
        if system.hpm3d is not None:
            system.hpm3d.train()
            # the 3d net trains on the ground-truth heatmaps (reference
            # hpm_model.py:97)
            with system.autocast():
                z_pred = system.hpm3d(heat)
            per = smooth_l1(z_pred.float(), z).mean(dim=-1)
            loss = _masked_mean(per, w) * lz_scale
            _update(system, system.hpm3d, system.opt3d, loss, lr)
            metrics["lz"] = loss.detach()
        system.step += 1
        if system.distributed:
            metrics = mean_metrics(metrics)
        return metrics

    return train_step
