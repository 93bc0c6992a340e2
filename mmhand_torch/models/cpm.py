"""CPM hand-pose networks of the HPE judge (counterpart of
mmhand_tpu/models/cpm.py; reference baselines/quantitative_on_benchmarks/
networks/net_hpm2d.py:26-120, net_hpm3d.py:27-145).

* Hpm2d: VGG-ish trunk (3 max pools, 32x32 at 256 input) + 6 CPM stages,
  each refining 21 heatmaps conditioned on the trunk features; every stage
  output is upsampled x8 with align_corners=True bilinear.
* Hpm3d: the same trunk and stages over the 21 predicted heatmaps, then a
  depth stage, a flatten in CHW order and three Linear layers with NO
  activation between them (reference quirk, net_hpm3d.py:138-141).  Torch's
  Linear needs its input width when it is built, so Hpm3d takes the input
  size: 21 * (size / 8)^2.

Module names are the reference's torch attribute names (``conv1_1``,
``conv5_3_CPM``, ``conv6_1_CPM``, ``stage2.conv1``, ``depth.conv1``,
``depth_fc_1``), so a reference state_dict loads as it is.  Inputs and
heatmaps are NHWC, float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the trunk's convs: (name, width), 3x3 pad 1 each, a 2x2 max pool after
# the last conv of blocks 1-3 (net_hpm2d.py:40-101)
_TRUNK = (("conv1_1", 64), ("conv1_2", 64), "pool",
          ("conv2_1", 128), ("conv2_2", 128), "pool",
          ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256),
          ("conv3_4", 256), "pool",
          ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512),
          ("conv4_4", 512), ("conv5_1", 512), ("conv5_2", 512),
          ("conv5_3_CPM", 128))


class CPMStage(nn.Module):
    """One refinement stage (reference net_hpm2d.py:4-24 'Repeat'): five
    7x7 convs and a 1x1 conv of 128, each with relu, then a 1x1 conv to
    ``num_joints`` maps."""

    def __init__(self, in_channels: int, num_joints: int):
        super().__init__()
        for i in range(5):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(in_channels if i == 0 else 128, 128, 7,
                              padding=3))
        self.conv6 = nn.Conv2d(128, 128, 1)
        self.conv7 = nn.Conv2d(128, num_joints, 1)

    def forward(self, x):
        for i in range(6):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        return self.conv7(x)


class _CPMBase(nn.Module):
    """Trunk, first-stage head and stages 2-6, shared by Hpm2d and Hpm3d."""

    def __init__(self, in_channels: int, num_joints: int):
        super().__init__()
        width = in_channels
        for layer in _TRUNK:
            if layer == "pool":
                continue
            name, out = layer
            setattr(self, name, nn.Conv2d(width, out, 3, padding=1))
            width = out
        self.conv6_1_CPM = nn.Conv2d(128, 512, 1)
        self.conv6_2_CPM = nn.Conv2d(512, num_joints, 1)
        for i in range(2, 7):
            setattr(self, f"stage{i}", CPMStage(num_joints + 128, num_joints))

    def stages(self, x):
        """NCHW input -> (trunk features, [stage 1..6 outputs])."""
        for layer in _TRUNK:
            if layer == "pool":
                x = F.max_pool2d(x, 2, stride=2)
            else:
                x = F.relu(getattr(self, layer[0])(x))
        feat = x
        out = self.conv6_2_CPM(F.relu(self.conv6_1_CPM(feat)))
        outputs = [out]
        for i in range(2, 7):
            outputs.append(getattr(self, f"stage{i}")(
                torch.cat([outputs[-1], feat], 1)))
        return feat, outputs


class Hpm2d(_CPMBase):
    """NHWC image -> 6 stage outputs of 21 heatmaps each, NHWC, upsampled
    x8 to the input resolution (reference net_hpm2d.py:26-120)."""

    def __init__(self, num_joints: int = 21):
        super().__init__(3, num_joints)

    def forward(self, x):
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        _, outputs = self.stages(x)
        return [F.interpolate(o, scale_factor=8, mode="bilinear",
                              align_corners=True).permute(0, 2, 3, 1)
                for o in outputs]


class Hpm3d(_CPMBase):
    """NHWC (size, size, 21) heatmaps -> (B, 21) z values (reference
    net_hpm3d.py:27-145)."""

    def __init__(self, num_joints: int = 21, size: int = 256):
        super().__init__(num_joints, num_joints)
        self.depth = CPMStage(num_joints + 128, num_joints)
        flat = num_joints * (size // 8) ** 2
        self.depth_fc_1 = nn.Linear(flat, 512)
        self.depth_fc_2 = nn.Linear(512, 512)
        self.depth_fc_3 = nn.Linear(512, num_joints)

    def forward(self, x):
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        feat, outputs = self.stages(x)
        out = self.depth(torch.cat([outputs[-1], feat], 1))
        # flatten in torch's CHW order (the reference's weight layout)
        out = out.reshape(out.shape[0], -1)
        # three Linear layers with NO activation between (reference quirk)
        return self.depth_fc_3(self.depth_fc_2(self.depth_fc_1(out)))


def load_cpm_npz(path: str) -> dict[str, torch.Tensor]:
    """A reference Hpm2d/Hpm3d state_dict from its .npz dump, with
    DataParallel's ``module.`` prefix removed (reference
    hpe_estimator.py:149-160)."""
    with np.load(path) as z:
        return {k.removeprefix("module."): torch.from_numpy(z[k])
                for k in z.files}
