"""The PoseResNet that the tests and ``chip_smoke.py`` hold the port's
PoseResNet and its BatchNorm kernels with, and its float64 functional
reference.

``make_test_pose_resnet`` draws kaiming weights, norm biases and running
statistics, scales the last BatchNorm of each residual block by 0.2 (as a
zero-init-residual net would stand after some training), so the residual
stream stays near unit scale, and the final layer by 0.05, so the heatmaps
lie within about +-0.3.  There f32 rounding through the 50 layers and the
train-mode deconv BatchNorms' E[x^2] - E[x]^2 (about 2e-5 relative) stays
below the checks' 1e-5 to 1e-4 tolerances.  One copy of these weights
keeps every check on the same numerics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mmhand_torch.models.baselines import PoseResNet, _ResnetBackboneBlock
from mmhand_torch.models.layers import init_weights


def make_test_pose_resnet(size: int, dtype: Optional[torch.dtype] = None,
                          seed: int = 0) -> PoseResNet:
    """PoseResNet-``size`` computing in ``dtype`` (None: float32), its
    weights drawn on the CPU from ``seed`` as the module docstring says."""
    net = PoseResNet(resnet_size=size, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    init_weights(net, "kaiming", gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.normal_(0, 0.1, generator=gen)
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
            if isinstance(m, _ResnetBackboneBlock):
                getattr(m, f"bn{m.n_convs}").weight.mul_(0.2)
        net.final_layer.weight.mul_(0.05)
    return net


def pose_resnet_f64(net: PoseResNet, x: torch.Tensor) -> torch.Tensor:
    """PoseResNet's train-mode forward with torch's functional ops
    (``F.batch_norm`` on the batch statistics), in ``x``'s dtype: the
    reference for the gradients, independent of the port's BatchNorm2d and
    its moments.  ``x`` is NHWC; so is the output."""

    def conv(m, h):
        return F.conv2d(h, m.weight, m.bias, m.stride, m.padding)

    def bn(m, h):
        return F.batch_norm(h, None, None, m.weight, m.bias, training=True,
                            eps=m.eps)

    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(torch.relu(bn(net.bn1, conv(net.conv1, h))), 3, 2, 1)
    for stage in range(1, 5):
        for block in getattr(net, f"layer{stage}"):
            out = h
            for c in range(1, block.n_convs + 1):
                out = bn(getattr(block, f"bn{c}"),
                         conv(getattr(block, f"conv{c}"), out))
                if c < block.n_convs:
                    out = torch.relu(out)
            res = h if block.downsample is None else bn(
                block.downsample[1], conv(block.downsample[0], h))
            h = torch.relu(out + res)
    layers = net.deconv_layers
    for i in range(0, len(layers), 3):
        d = layers[i]
        h = torch.relu(bn(layers[i + 1], F.conv_transpose2d(
            h, d.weight, d.bias, d.stride, d.padding, d.output_padding)))
    return conv(net.final_layer, h).permute(0, 2, 3, 1)
