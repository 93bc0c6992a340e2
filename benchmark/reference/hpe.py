"""The plain reference of the ratio study's hand-pose estimator, MM-Hand's
``hpm`` trainer (hand_pose_estimators/CVPR2020_hpm3d of VITA-Group/mm-hand):
Hpm2d, a VGG-style trunk and six CPM stages whose outputs are upsampled x8,
trained on the sum of the stages' MSE against sigma-5 heatmaps x1000; and
Hpm3d, the same trunk and stages over the ground-truth heatmaps, a depth
stage and three linear layers with no activation between them, trained on
SmoothL1 of the 21 depths / 0.7; one Adam each.

Float32, plain torch (``layers``); module names follow the reference's
torch attributes, so one weight dictionary, keyed ``<net>.<parameter>``,
loads into the reference and the measured program alike.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.gan import heatmaps, normalize
from benchmark.reference.layers import QConv2d, QLinear, adam_step
from benchmark.traffic.png import read_png

Z_SCALE = 0.7
LOSS_KEYS = ("mse", "lz")
_TRUNK = (("conv1_1", 64), ("conv1_2", 64), "pool",
          ("conv2_1", 128), ("conv2_2", 128), "pool",
          ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256),
          ("conv3_4", 256), "pool",
          ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512),
          ("conv4_4", 512), ("conv5_1", 512), ("conv5_2", 512),
          ("conv5_3_CPM", 128))


class Stage(nn.Module):
    """Five 7x7 convs and a 1x1 conv of 128, each with relu, then a 1x1
    conv to the joints' maps."""

    def __init__(self, cin: int, joints: int):
        super().__init__()
        for i in range(5):
            setattr(self, f"conv{i + 1}",
                    QConv2d(cin if i == 0 else 128, 128, 7, padding=3))
        self.conv6 = QConv2d(128, 128, 1)
        self.conv7 = QConv2d(128, joints, 1)

    def forward(self, x):
        for i in range(6):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        return self.conv7(x)


class _CPM(nn.Module):
    def __init__(self, cin: int, joints: int):
        super().__init__()
        width = cin
        for layer in _TRUNK:
            if layer != "pool":
                setattr(self, layer[0], QConv2d(width, layer[1], 3,
                                                padding=1))
                width = layer[1]
        self.conv6_1_CPM = QConv2d(128, 512, 1)
        self.conv6_2_CPM = QConv2d(512, joints, 1)
        for i in range(2, 7):
            setattr(self, f"stage{i}", Stage(joints + 128, joints))

    def stages(self, x):
        for layer in _TRUNK:
            x = (F.max_pool2d(x, 2, 2) if layer == "pool"
                 else F.relu(getattr(self, layer[0])(x)))
        feat = x
        outs = [self.conv6_2_CPM(F.relu(self.conv6_1_CPM(feat)))]
        for i in range(2, 7):
            outs.append(getattr(self, f"stage{i}")(
                torch.cat([outs[-1], feat], 1)))
        return feat, outs


class Hpm2d(_CPM):
    def __init__(self, joints: int = 21):
        super().__init__(3, joints)

    def forward(self, x):
        _, outs = self.stages(x.permute(0, 3, 1, 2))
        return [F.interpolate(o, scale_factor=8, mode="bilinear",
                              align_corners=True).permute(0, 2, 3, 1)
                for o in outs]


class Hpm3d(_CPM):
    def __init__(self, joints: int = 21, size: int = 256):
        super().__init__(joints, joints)
        self.depth = Stage(joints + 128, joints)
        self.depth_fc_1 = QLinear(joints * (size // 8) ** 2, 512)
        self.depth_fc_2 = QLinear(512, 512)
        self.depth_fc_3 = QLinear(512, joints)

    def forward(self, x):
        feat, outs = self.stages(x.permute(0, 3, 1, 2))
        out = self.depth(torch.cat([outs[-1], feat], 1))
        out = out.reshape(out.shape[0], -1)
        return self.depth_fc_3(self.depth_fc_2(self.depth_fc_1(out)))


def build_nets(joints: int, size: int, device) -> dict:
    return {"hpm2d": Hpm2d(joints).to(device),
            "hpm3d": Hpm3d(joints, size).to(device)}


def hpe_batch(root: str, annos: dict, paths, sigma: float, device) -> dict:
    """image in [-1, 1], sigma-5 heatmaps, z = depth / 0.7, weight 1."""
    names = [os.path.basename(p) for p in paths]
    img = torch.from_numpy(np.stack([
        read_png(os.path.join(root, "color", n)) for n in names])).to(device)
    uv = torch.from_numpy(np.stack([
        np.asarray(annos["color"][n]["uv_coord"], np.float32)
        for n in names])).to(device)
    z = torch.from_numpy(np.stack([
        np.asarray(annos["color"][n]["depth"], np.float32)
        for n in names])).to(device) / Z_SCALE
    return {"image": normalize(img),
            "heatmaps": heatmaps(uv, img.shape[1], sigma), "z": z,
            "weight": torch.ones(len(names), device=device)}


def _smooth_l1(d: torch.Tensor) -> torch.Tensor:
    a = d.abs()
    return torch.where(a < 1.0, 0.5 * a * a, a - 0.5)


def _masked_mean(per: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (per * w).sum() / w.sum().clamp(min=1.0)


def train_steps(nets: dict, batches: list, lrs: list, hp: dict) -> dict:
    """The ``hpm`` trainer's steps (see ``gan.train_steps`` for what is
    returned).  ``hp``: beta1, beta2, stage_loss_scale."""
    start = {f"{k}.{n}": p.detach().clone()
             for k, net in nets.items() for n, p in net.named_parameters()}
    states = {k: {} for k in nets}
    losses, grad_norms = [], {}
    for i, (b, lr) in enumerate(zip(batches, lrs)):
        w = b["weight"]
        stages = nets["hpm2d"](b["image"])
        mse = sum(_masked_mean(((s - b["heatmaps"]) ** 2).mean(dim=(1, 2, 3)),
                               w) for s in stages) * hp["stage_loss_scale"]
        z = nets["hpm3d"](b["heatmaps"])
        lz = _masked_mean(_smooth_l1(z - b["z"]).mean(dim=-1), w)
        for key, loss in (("hpm2d", mse), ("hpm3d", lz)):
            params = list(nets[key].parameters())
            grads = torch.autograd.grad(loss, params)
            if i == 0:
                for (n, _), g in zip(nets[key].named_parameters(), grads):
                    grad_norms[f"{key}.{n}"] = float(g.norm())
            adam_step(params, grads, states[key], lr,
                      (hp["beta1"], hp["beta2"]), 1e-8)
        losses.append({"mse": float(mse.detach()), "lz": float(lz.detach())})
    change = {f"{k}.{n}": float((p.detach() - start[f"{k}.{n}"]).norm())
              for k, net in nets.items() for n, p in net.named_parameters()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
