"""The yardstick's arithmetic: the H100's peaks, the least time of a piece of
work, the bytes and operations of the port's kernels K1 (Gaussian
heatmaps), K2 (BatchNorm moments) and K2b (their backward), and the model
FLOPs of a step, counted from the layers' shapes.

Peaks are NVIDIA's published dense rates of one H100 SXM at its 700 W limit;
a run prints the card's own power limit beside every share of them.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12          # H100 SXM, outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM, dense bf16 on the tensor cores

# the program's heatmap clip and the kernel's early-out margin
HEATMAP_CLIP = 0.0099
HEATMAP_SKIP_MARGIN = 0.05


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds for the work: bytes over HBM bandwidth or f32
    operations over the f32 peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def k1_bound_s(uv: torch.Tensor, height: int, width: int,
               sigma: float) -> float:
    """K1 on keypoints ``uv`` (B, K, 2): it writes (B, H, W, K) float32 once
    and reads uv; each element it does not skip costs 9 operations (the
    distance, the exponent and the clip).  An element is skipped where
    d^2 >= 2 sigma^2 (ln(1 / clip) + margin)."""
    uv = uv.detach().to("cpu", torch.float32)
    b, k = uv.shape[0], uv.shape[1]
    out_bytes = b * height * width * k * 4
    skip = 2.0 * sigma * sigma * (math.log(1.0 / HEATMAP_CLIP)
                                 + HEATMAP_SKIP_MARGIN)
    dx2 = (torch.arange(width, dtype=torch.float32)[None, :, None]
           - uv[:, None, :, 0]) ** 2                   # (B, W, K)
    dy2 = (torch.arange(height, dtype=torch.float32)[None, :, None]
           - uv[:, None, :, 1]) ** 2                   # (B, H, K)
    kept = sum(int((dy2[i][:, None, :] + dx2[i][None, :, :] < skip).sum())
               for i in range(b))
    return bound_s(out_bytes + uv.numel() * 4, 9.0 * kept)


def k2_bound_s(numel: int, element_size: int, channels: int) -> float:
    """K2 reads x once and writes two float32 sums per channel; 3
    operations an element (a square and two adds)."""
    return bound_s(numel * element_size + 2 * channels * 4, 3.0 * numel)


def k2b_bound_s(numel: int, element_size: int, channels: int) -> float:
    """K2b reads x and two float32 gradients per channel and writes dx; 2
    operations an element (a multiply-add)."""
    return bound_s(2 * numel * element_size + 2 * channels * 4, 2.0 * numel)


_MAC_LAYERS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def _macs(module: nn.Module, inp: torch.Tensor, out: torch.Tensor) -> int:
    """Multiply-adds of one forward of a conv, conv-transpose or linear."""
    if isinstance(module, nn.Linear):
        return out.numel() * module.in_features
    if isinstance(module, nn.ConvTranspose2d):
        # every input element meets every tap of its output channels
        taps = math.prod(module.kernel_size)
        return inp.numel() * module.out_channels // module.groups * taps
    taps = math.prod(module.kernel_size)
    return out.numel() * module.in_channels // module.groups * taps


class FlopCounter:
    """Model FLOPs of what runs while ``counting`` is open, from forward
    hooks on every conv, conv-transpose and linear layer of ``nets``.

    A forward costs 2 x its multiply-adds.  Where autograd will form the
    gradient of the layer's input (grad mode on and the input requires
    it), the backward adds as many again; where the layer's weight
    requires a gradient, as many again.  Nothing is counted twice, and
    nothing that is recomputed."""

    def __init__(self, nets):
        self.nets = list(nets)
        self.flops = 0

    def _hook(self, module, args, out):
        macs = _macs(module, args[0], out)
        passes = 1
        if torch.is_grad_enabled():
            passes += int(args[0].requires_grad)
            passes += int(module.weight.requires_grad)
        self.flops += 2 * macs * passes

    @contextlib.contextmanager
    def counting(self):
        hooks = [m.register_forward_hook(self._hook) for net in self.nets
                 for m in net.modules() if isinstance(m, _MAC_LAYERS)]
        try:
            yield self
        finally:
            for h in hooks:
                h.remove()


class BatchNormSites:
    """The train-mode BatchNorm calls of ``nets`` while ``recording`` is
    open: each site's K2 bound, and K2b's where the backward will form
    the input's gradient."""

    def __init__(self, nets):
        self.nets = list(nets)
        self.k2_s = 0.0
        self.k2b_s = 0.0

    def _hook(self, module, args):
        if not module.training:
            return
        x = args[0]
        shape = (x.numel(), x.element_size(), x.shape[1])
        self.k2_s += k2_bound_s(*shape)
        if torch.is_grad_enabled() and x.requires_grad:
            self.k2b_s += k2b_bound_s(*shape)

    @contextlib.contextmanager
    def recording(self):
        hooks = [m.register_forward_pre_hook(self._hook) for net in self.nets
                 for m in net.modules()
                 if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d))]
        try:
            yield self
        finally:
            for h in hooks:
                h.remove()
