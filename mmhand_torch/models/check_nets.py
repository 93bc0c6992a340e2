"""The PoseResNet that the tests and ``chip_smoke.py`` hold the port's
PoseResNet and its BatchNorm kernels with, and its float64 functional
reference; how they hold a net's gradients on the card against the CPU
(``kink_decisions``, ``gradients_off``); and which voxels of a V2V cube
may differ between two devices (``edge_voxels``, ``bone_boundary``).

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

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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


def biases_before_batchnorm(net: nn.Module) -> dict[str, str]:
    """{name of a conv's bias: name of the bias of the BatchNorm that
    follows it directly in an ``nn.Sequential``}."""
    pairs = {}
    for prefix, m in net.named_modules():
        if not isinstance(m, nn.Sequential):
            continue
        kids = list(m.named_children())
        for (a, conv), (b, bn) in zip(kids, kids[1:]):
            if (isinstance(conv, nn.modules.conv._ConvNd)
                    and conv.bias is not None
                    and isinstance(bn, nn.modules.batchnorm._BatchNorm)):
                p = f"{prefix}." if prefix else ""
                pairs[f"{p}{a}.bias"] = f"{p}{b}.bias"
    return pairs


def gradient_errors(exact: nn.Module, approx: nn.Module) -> dict[str, float]:
    """Two copies of a net after one backward pass each (``exact`` on the
    CPU): {parameter: |g_approx - g_exact| / |g_exact|} (norms of whole
    tensors) over every parameter but the conv biases that feed a
    train-mode BatchNorm.  Their gradient is 0 in exact arithmetic (the
    BatchNorm subtracts the channel's mean, so the bias does not reach the
    output); either side holds its own rounding noise there, and there is
    nothing to compare."""
    skip = biases_before_batchnorm(exact)
    g = {k: p.grad.detach().cpu().double()
         for k, p in approx.named_parameters()}
    return {k: float((g[k] - p.grad).norm()) / max(float(p.grad.norm()),
                                                   1e-300)
            for k, p in exact.named_parameters() if k not in skip}


def gradients_off(exact: nn.Module, cpu: nn.Module, card: nn.Module,
                  rel: float = 1e-4) -> tuple[list[str], float, float]:
    """A net's gradients on the card against the CPU's float32 ones, each
    leaf within ``rel`` of its norm plus 4x the CPU's own distance from the
    float64 gradient of ``exact`` (``gradient_errors``).  Where a float32
    gradient is a sum that nearly cancels, either device is off by far more
    than 1e-4 of its norm (the CPU by 3e-3 in DepthDiscriminator's
    ``encoder.0.bias`` at 2 x 256 x 256, where an H100 is off by 5e-6), and
    the CPU's own error there is the yardstick of that rounding.  Returns
    the leaves out of bounds, the largest card-CPU gap and the largest
    CPU-float64 error.  Run every pass but the card's under
    ``kink_decisions`` replaying the card's decisions, or a (Leaky)ReLU
    input within rounding of 0 on one side only takes the other slope there
    and changes every gradient below it."""
    gap = gradient_errors(cpu, card)
    e_cpu = gradient_errors(exact, cpu)
    off = [k for k, e in gap.items() if e > rel + 4 * e_cpu[k]]
    return off, max(gap.values()), max(e_cpu.values())


_KINKS = ("relu", "leaky_relu", "max_pool2d", "max_pool3d")
# how far from its kink (a ReLU's 0, a pool window's tie) a replayed
# decision that differs from the CPU's own may lie, as a share of the op
# input's largest |x|: the two devices' f32 rounding, and after a step the
# rounding of that step's weights
KINK_MARGIN = 1e-4


@contextlib.contextmanager
def kink_decisions(record: Optional[list] = None, replay=None,
                   margins: Optional[list] = None):
    """``F.relu``, ``F.leaky_relu``, ``F.max_pool2d`` and ``F.max_pool3d``
    that append their decisions (which inputs pass each (leaky) ReLU; which
    element each pool window takes) to the list ``record``, or take them
    from the iterator ``replay`` in place of their own.

    Where an input lies within rounding of 0, or two pooled values within
    rounding of each other, the card and the CPU may decide apart, each a
    valid subgradient that moves every gradient below it; replaying the
    card's decisions on the CPU leaves only the arithmetic to compare.  So
    that the replay hides nothing else, each replayed call also makes its
    own decisions and appends to ``margins`` (op, how many of the
    replayed decisions differ from its own, and the largest distance of
    its own input from the replayed decision at them, as a share of the
    input's largest |x|: |x| at a ReLU, own max - replayed value at a
    pool); the caller holds that share at rounding level.  The nets must
    call these through ``torch.nn.functional`` (``nn.ReLU``,
    ``nn.LeakyReLU`` and ``nn.MaxPool*d`` do)."""
    saved = {name: getattr(F, name) for name in _KINKS}

    def note(name, differ, distance, x):
        worst = float(distance[differ].max()) if bool(differ.any()) else 0.0
        margins.append((name, int(differ.sum()),
                        worst / max(float(x.detach().abs().max()), 1e-30)))

    def activation(name):
        def recorded(x, *args, **kwargs):
            record.append((name, (x > 0).cpu()))
            return saved[name](x, *args, **kwargs)

        def replayed(x, *args, **kwargs):
            kind, passed = next(replay)
            if kind != name or passed.shape != x.shape:
                raise RuntimeError(f"replaying {kind} {tuple(passed.shape)} "
                                   f"at {name} {tuple(x.shape)}")
            passed = passed.to(x.device)
            slope = 0.0 if name == "relu" else kwargs.get(
                "negative_slope", args[0] if args else 0.01)
            note(name, passed != (x > 0), x.detach().abs(), x)
            # in the op's own output layout, strides of size-1 axes
            # included, so that the ops after it round as they would
            return torch.empty_like(x).copy_(
                x * torch.where(passed, 1.0, slope).to(x.dtype))

        return recorded if replay is None else replayed

    def pool(name):
        def indices(x, args, kwargs):
            if kwargs.pop("return_indices", False):
                raise NotImplementedError(f"{name} with return_indices")
            return saved[name](x, *args, return_indices=True, **kwargs)

        def recorded(x, *args, **kwargs):
            y, index = indices(x, args, kwargs)
            record.append((name, index.cpu()))
            return y

        def replayed(x, *args, **kwargs):
            kind, index = next(replay)
            own, own_index = indices(x, args, kwargs)
            if kind != name or index.shape != own_index.shape:
                raise RuntimeError(f"replaying {kind} {tuple(index.shape)} "
                                   f"at {name} {tuple(own_index.shape)}")
            index = index.to(x.device)
            # in the pool's own output layout (as above)
            y = torch.empty_like(own).copy_(
                x.flatten(2).gather(2, index.flatten(2)).view(index.shape))
            note(name, index != own_index, (own - y).detach(), x)
            return y

        return recorded if replay is None else replayed

    for name in _KINKS:
        setattr(F, name, (pool if name.startswith("max_pool") else
                          activation)(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(F, name, fn)


def edge_voxels(coord, size: int, tol: float) -> np.ndarray:
    """(size,)*3 bool: the voxels a point of ``coord`` (N, 3) may land in if
    each coordinate moves by up to ``tol``, where that changes its voxel."""
    c = np.asarray(coord, np.float64)
    lo = np.floor(c - tol).astype(np.int64)
    hi = np.floor(c + tol).astype(np.int64)
    out = np.zeros((size,) * 3, bool)
    moved = (lo != hi).any(1)
    for a, b in zip(lo[moved], hi[moved]):
        sl = tuple(slice(max(0, x), max(0, min(size, y + 1)))
                   for x, y in zip(a, b))
        out[sl] = True
    return out


def bone_boundary(coord, size: int, tol: float) -> np.ndarray:
    """(size,)*3 bool: voxels where a bone capsule's quadric, in float64
    from the keypoints' voxel coordinates ``coord`` (21, 3), lies within
    ``tol`` of 1, so that float32 rounding may put them on either side."""
    from mmhand_torch.ops.voxelize import (
        BONE_ROTATION,
        CONNECTIONS,
        ellipsoid_quadric,
    )

    c = torch.as_tensor(np.asarray(coord, np.float64))
    j1, j2 = c[CONNECTIONS[:, 0]], c[CONNECTIONS[:, 1]]
    d = ((j1 - j2) ** 2).sum(1).sqrt()
    centers = (j1 - j2).abs() / 2 + torch.minimum(j1, j2)
    q = ellipsoid_quadric(size, centers, (d / 2.5)[:, None].expand(-1, 3),
                          torch.deg2rad(torch.tensor(BONE_ROTATION,
                                                     dtype=torch.float64)))
    return ((q - 1.0).abs() < tol).any(0).numpy()
