"""The hand3d trainer: staged-LR Adam on one subnet at a time (counterpart
of mmhand_tpu/hand3d/system.py; reference
hand_pose_estimators/CVPR2020_hand3d/training_handsegnet.py,
training_posenet.py, training_lifting.py).

* handsegnet: softmax cross-entropy of the upsampled 2-class scoremap
  against the hand mask (training_handsegnet.py:59-64); lr 1e-5, 1e-6, 1e-7
  from steps 20000 and 30000.
* posenet: sum(vis * sqrt(mean over HW of the squared error)) /
  (sum(vis) + 0.001) per stage, summed over the 3 stages resized to the
  ground truth's size (training_posenet.py:61-66); lr 1e-4, 1e-5, 1e-6 from
  10000 and 20000.
* lifting (PosePriorNetwork): the variant's MSE (training_lifting.py:64-78):
  local against xyz21_local; local_w_xyz_loss, direct and bottleneck
  against xyz21_normed; proposed against xyz21_can plus the MSE of R
  against rot_mat; lr 1e-5, 1e-6 from 60000.

Adam as ``optax.scale_by_adam`` (betas 0.9, 0.999, eps 1e-8), its learning
rate set from ``staged_lr`` at each step.  The weights are drawn as the
reference's init (xavier-uniform, biases 1e-4) from ``seed`` on the CPU.
Over several ranks the gradients are averaged in one all-reduce and the
loss is averaged, as mmhand_tpu's ``pmean``; each rank draws its dropout
from its own stream, and the weights stay the same on every rank.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from mmhand_torch.models.hand3d import (
    ColorHandPose3D,
    HandSegNet,
    PoseNet2D,
    PosePriorNetwork,
    init_hand3d,
)
from mmhand_torch.ops.hand3d_image import resize_bilinear_tf1
from mmhand_torch.parallel.sharding import mean_metrics
from mmhand_torch.train.state import (
    backward_and_step,
    load_adam_state_dict,
    rank_seed,
    set_lr,
    step_span,
)
from mmhand_torch.utils import trace

# the reference training_*.py train_para dicts
TRAIN_PARA_HANDSEGNET = {
    "lr": [1e-5, 1e-6, 1e-7], "lr_iter": [20000, 30000],
    "max_iter": 40000, "show_loss_freq": 1000, "snapshot_freq": 5000}
TRAIN_PARA_POSENET = {
    "lr": [1e-4, 1e-5, 1e-6], "lr_iter": [10000, 20000],
    "max_iter": 30000, "show_loss_freq": 1000, "snapshot_freq": 5000}
TRAIN_PARA_LIFTING = {
    "lr": [1e-5, 1e-6], "lr_iter": [60000],
    "max_iter": 80000, "show_loss_freq": 1000, "snapshot_freq": 5000}
NETS = ("handsegnet", "posenet", "lifting")


def make_net(net: str, variant: str = "proposed", crop_size: int = 256
             ) -> tuple[torch.nn.Module, dict]:
    """The subnet ``net`` as constructed, on the default device, and its
    train_para."""
    if net == "handsegnet":
        return HandSegNet(), TRAIN_PARA_HANDSEGNET
    if net == "posenet":
        return PoseNet2D(), TRAIN_PARA_POSENET
    if net == "lifting":
        return (PosePriorNetwork(variant=variant, crop_size=crop_size),
                TRAIN_PARA_LIFTING)
    raise ValueError(f"unknown hand3d net [{net}]")


def make_adam(module: torch.nn.Module, para: dict) -> torch.optim.Adam:
    """``optax.scale_by_adam``'s defaults at the first staged rate."""
    return torch.optim.Adam(module.parameters(), lr=para["lr"][0],
                            betas=(0.9, 0.999), eps=1e-8)


def staged_lr(values, steps, global_step: int) -> float:
    """The piecewise-constant learning rate (reference utils/general.py
    LearningRateScheduler): values[i + 1] from global_step steps[i] on."""
    lr = values[0]
    for v, s in zip(values[1:], steps):
        if global_step >= s:
            lr = v
    return lr


class Hand3DSystem:
    """One hand3d subnet, its Adam and its step on ``device``.

    ``net``: handsegnet, posenet or lifting (a PosePriorNetwork of
    ``variant`` at ``crop_size``).  ``distributed``: this process is one rank
    of the initialized torch.distributed group.  ``state_dict`` and
    ``load_state_dict`` hold the net, the Adam, the step and each rank's
    dropout stream, for ``CheckpointManager``."""

    def __init__(self, net: str = "posenet", variant: str = "proposed",
                 crop_size: int = 256, device="cuda", seed: int = 0,
                 distributed: bool = False):
        module, para = make_net(net, variant, crop_size)
        self.net, self.variant, self.train_para = net, variant, para
        self.device = torch.device(device)
        self.distributed = distributed
        self.rank, self.world = ((dist.get_rank(), dist.get_world_size())
                                 if distributed else (0, 1))
        with trace.timed("setup.init_weights_s"):
            init_hand3d(module, torch.Generator().manual_seed(seed))
            self.module = module.to(self.device)
        self.opt = make_adam(self.module, para)
        self.seed = seed
        self.dropout_gen = torch.Generator(self.device).manual_seed(
            rank_seed(seed, self.rank))
        self.step = 0

    def state_dict(self) -> dict:
        """The train state; the dropout stream under ``"rank"``."""
        return {"net": self.net, "variant": self.variant, "step": self.step,
                "module": self.module.state_dict(),
                "opt": self.opt.state_dict(),
                "rank": {"dropout_rng": self.dropout_gen.get_state()}}

    def load_state_dict(self, d: dict) -> None:
        if (d["net"], d["variant"]) != (self.net, self.variant):
            raise ValueError(f"the checkpoint holds {d['net']} "
                             f"({d['variant']}), this system {self.net} "
                             f"({self.variant})")
        self.module.load_state_dict(d["module"])
        load_adam_state_dict(self.opt, d["opt"])
        self.step = int(d["step"])
        if d.get("rng") == "fresh":  # a JAX export holds no stream
            self.dropout_gen.manual_seed(rank_seed(self.seed, self.rank))
        else:
            self.dropout_gen.set_state(d["rank"]["dropout_rng"].cpu())

    # ------------------------------------------------------------ losses
    def loss_fn(self, batch: dict) -> torch.Tensor:
        """The subnet's loss on a ``derive_batch`` dict."""
        if self.net == "handsegnet":
            pred = self.module(batch["image"])
            gt = batch["hand_mask"].float()
            logp = torch.log_softmax(pred, dim=-1)
            return torch.mean(-torch.sum(gt * logp, dim=-1))

        if self.net == "posenet":
            gt = batch["scoremap"]
            b, h, w, k = gt.shape
            vis = batch["keypoint_vis21"].float().reshape(b, k)
            loss = 0.0
            for pred in self.module(batch["image"]):
                pred = resize_bilinear_tf1(pred, (h, w))
                per_kp = torch.sqrt(torch.mean((pred - gt) ** 2, dim=(1, 2)))
                loss = loss + torch.sum(vis * per_kp) / (torch.sum(vis)
                                                         + 0.001)
            return loss

        coord_normed, coord3d, rot = self.module(
            batch["scoremap"], batch["hand_side"], train=True,
            generator=self.dropout_gen)
        if self.variant == "local":
            return torch.mean((coord3d - batch["keypoint_xyz21_local"]) ** 2)
        if self.variant in ("local_w_xyz_loss", "direct", "bottleneck"):
            return torch.mean((coord_normed
                               - batch["keypoint_xyz21_normed"]) ** 2)
        loss = torch.mean((coord3d - batch["keypoint_xyz21_can"]) ** 2)
        return loss + torch.mean((rot - batch["rot_mat"]) ** 2)


def make_hand3d_train_step(system: Hand3DSystem):
    """step(batch) -> the 0-d loss, averaged over the ranks; sets the
    learning rate of ``system.step`` from ``staged_lr`` and advances it.
    Each call begins a step (``utils.trace``) and is the host span
    ``step``; the forward and loss are the device span ``hand3d.forward``,
    then ``backward``, ``allreduce`` over several ranks, and ``adam``."""
    values = system.train_para["lr"]
    steps = system.train_para["lr_iter"]
    device = system.device

    def train_step(batch: dict) -> torch.Tensor:
        with step_span():
            return _train_step(batch)

    def _train_step(batch: dict) -> torch.Tensor:
        system.module.train()
        set_lr(system.opt, staged_lr(values, steps, system.step))
        system.opt.zero_grad(set_to_none=True)
        with trace.span("hand3d.forward", device):
            loss = system.loss_fn(batch)
        backward_and_step(system.module, system.opt, loss, device,
                          system.distributed)
        system.step += 1
        loss = loss.detach()
        if system.distributed:
            loss = mean_metrics({"loss": loss})["loss"]
        return loss

    return train_step


def load_color_hand_pose(checkpoints_dir: Optional[str], name: str,
                         crop_size: int = 256, device="cuda"
                         ) -> tuple[ColorHandPose3D, bool]:
    """The whole pipeline in eval mode on ``device``, and whether its
    weights came from ``<checkpoints_dir>/<name>_full/state_latest.pt``
    (its ``"module"``); where there is no such file they are drawn from
    seed 0, as mmhand_tpu initializes from PRNGKey(0)."""
    net = init_hand3d(ColorHandPose3D(crop_size=crop_size),
                      torch.Generator().manual_seed(0))
    path = (None if checkpoints_dir is None else
            os.path.join(checkpoints_dir, f"{name}_full", "state_latest.pt"))
    found = path is not None and os.path.exists(path)
    if found:
        net.load_state_dict(torch.load(path, map_location="cpu",
                                       weights_only=True)["module"])
    return net.to(device).eval(), found
