"""Layer builders for the port's networks (counterpart of
mmhand_tpu/models/layers.py, plain branch of each layer).

Modules are NCHW, as torch's convolutions are; the networks take NHWC at
their public ``forward`` and run ``channels_last`` inside.  Each builder
returns the flat list of layers that the reference torch code puts into an
``nn.Sequential``, so a network's ``state_dict`` has the reference layout that
tools/convert_mmhand_torch.py parses.

Weight init matches the reference's (reference models/network_utils.py:
12-72): conv kernels ~ N(0, 0.02) by default, or xavier, kaiming or
orthogonal (``init_weights``); biases 0, norm scales ~ N(1, 0.02), norm
biases 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from mmhand_torch.ops.bn_stats import bn_apply, bn_moments
from mmhand_torch.ops.reflect_pad import reflect_pad
from mmhand_torch.parallel.sharding import all_reduce_sum


@dataclasses.dataclass(frozen=True)
class NormConfig:
    """Normalization choice (reference network_utils.py:74-84
    get_norm_layer): 'batch' (affine), 'instance' (no affine) or 'none'.

    ``cross_rank`` averages the train-mode BatchNorm moments over the ranks
    of torch.distributed (sync-BN), mmhand_tpu's ``axis_name``."""

    kind: str = "batch"
    cross_rank: bool = False

    @property
    def use_bias(self) -> bool:
        """Convs skip their bias before an affine BatchNorm and keep it with
        InstanceNorm (reference models/Generator.py:152-155)."""
        return self.kind == "instance"


class _FlaxBatchNorm:
    """BatchNorm with eps 1e-5 and momentum 0.1 (flax momentum 0.9).

    Train mode normalizes with the f32 batch moments of ``ops.bn_moments``
    (kernel K2 on a CUDA device; float64 for a float64 net on the CPU), var = max(0, E[x^2] - E[x]^2) as flax's
    fast variance and mmhand_tpu's ``_DotStatsBN`` (mmhand_tpu/models/
    layers.py:177-193), through ``ops.bn_apply`` (one kernel each way on a
    CUDA device), and folds the *biased* batch variance into
    ``running_var``; torch's own BatchNorm folds the unbiased one.  While
    ``update_running_stats`` is False (``frozen_running_stats``), train mode
    leaves the running statistics as they are.  Eval mode is torch's
    BatchNorm over the running statistics.

    With ``cross_rank``, every train-mode forward averages the stacked
    (mean, mean of squares) over the ranks (a mean of moments, as
    mmhand_tpu's ``pmean`` at mmhand_tpu/models/layers.py:183-185), the
    discriminator forwards of the G loss included; the backward sums the
    moments' gradients over the ranks before K2b."""

    def __init__(self, features: int, cross_rank: bool = False):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.update_running_stats = True
        self.cross_rank = cross_rank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean, mean_sq = bn_moments(x)
        if self.cross_rank:
            stats = (all_reduce_sum(torch.stack([mean, mean_sq]))
                     / dist.get_world_size())
            mean, mean_sq = stats.unbind()
        if self.update_running_stats:
            with torch.no_grad():
                var = torch.clamp(mean_sq - mean * mean, min=0.0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked += 1
        return bn_apply(x, mean, mean_sq, self.weight, self.bias, self.eps)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """The port's BatchNorm of (B, C, H, W) activations (``_FlaxBatchNorm``;
    K2 and K2b take them in ``channels_last`` memory)."""


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    """The port's BatchNorm of (B, C, D, H, W) activations
    (``_FlaxBatchNorm``; K2 and K2b take them in ``channels_last_3d``
    memory), flax's ``nn.BatchNorm`` of the voxel nets."""


def in_net_dtype(net: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x`` in the type of ``net``'s parameters (float32, or float64 for a
    float64 reference copy)."""
    return x.to(next(net.parameters()).dtype)


@contextlib.contextmanager
def frozen_running_stats(*nets: nn.Module):
    """Train-mode forwards of ``nets`` inside the block keep their
    BatchNorm2d and BatchNorm3d running statistics unchanged, as the JAX
    step discards the updates of the discriminator forwards in the G loss
    (mmhand_tpu/train/step.py:224-236)."""
    bns = [m for net in nets for m in net.modules()
           if isinstance(m, _FlaxBatchNorm)]
    saved = [m.update_running_stats for m in bns]
    for m in bns:
        m.update_running_stats = False
    try:
        yield
    finally:
        for m, flag in zip(bns, saved):
            m.update_running_stats = flag


def norm_layer(cfg: NormConfig, features: int) -> nn.Module:
    """mmhand_tpu ``Norm``: the normalization module ``cfg`` names."""
    if cfg.kind == "batch":
        return BatchNorm2d(features, cross_rank=cfg.cross_rank)
    if cfg.kind == "instance":
        # InstanceNorm2d(affine=False): per-sample per-channel over H, W
        return nn.InstanceNorm2d(features, eps=1e-5, affine=False)
    if cfg.kind == "none":
        return nn.Identity()
    raise NotImplementedError(f"norm [{cfg.kind}] not found")


class ReflectPad2d(nn.Module):
    """Reflect padding of H and W by ``padding`` on each side
    (``ops.reflect_pad``: ATen's pad on the CPU, the hand-written kernels
    on CUDA, which take a channels_last input), in the input's type.  It
    holds no parameter or buffer, so a network's ``state_dict`` keeps the
    keys and ``nn.Sequential`` indices it had with
    ``nn.ReflectionPad2d``."""

    def __init__(self, padding: int):
        super().__init__()
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_pad(x, self.padding)

    def extra_repr(self) -> str:
        return str(self.padding)


_PAD_LAYERS = {"reflect": ReflectPad2d,
               "replicate": nn.ReplicationPad2d}


def pad_conv(in_features: int, features: int, kernel: int, stride: int = 1,
             pad: int = 0, pad_mode: str = "reflect",
             use_bias: bool = True) -> list[nn.Module]:
    """mmhand_tpu ``PadConv``: spatial padding, then a VALID conv.

    Reflect and replicate padding are a pad layer before
    ``Conv2d(padding=0)``; zero padding is the conv's own ``padding``, as in
    the reference (models/Generator.py build_conv_block)."""
    if pad and pad_mode in _PAD_LAYERS:
        return [_PAD_LAYERS[pad_mode](pad),
                nn.Conv2d(in_features, features, kernel, stride,
                          bias=use_bias)]
    if pad and pad_mode != "zero":
        raise NotImplementedError(f"padding [{pad_mode}] is not implemented")
    return [nn.Conv2d(in_features, features, kernel, stride, padding=pad,
                      bias=use_bias)]


def strided_conv(in_features: int, features: int, kernel: int = 3,
                 stride: int = 2, padding: int = 1,
                 use_bias: bool = False) -> nn.Conv2d:
    """mmhand_tpu ``StridedConv``: conv with symmetric zero padding (the
    k3 s2 p1 downsampling convs of the stems)."""
    return nn.Conv2d(in_features, features, kernel, stride, padding=padding,
                     bias=use_bias)


def up_conv(in_features: int, features: int, use_bias: bool = False,
            kernel: int = 3, output_padding: int = 1) -> nn.ConvTranspose2d:
    """mmhand_tpu ``UpConv``: a stride-2 ConvTranspose2d with padding 1, by
    default (k3, op1), the generator's 2x upsampler (reference
    models/Generator.py:243-253); the pix2pix UNet's is (k4, op0)."""
    return nn.ConvTranspose2d(in_features, features, kernel, stride=2,
                              padding=1, output_padding=output_padding,
                              bias=use_bias)


def conv_norm_relu(in_features: int, features: int, kernel: int,
                   norm: NormConfig, stride: int = 1, pad: int = 0,
                   pad_mode: str = "reflect",
                   zero_pad_in_conv: bool = False) -> list[nn.Module]:
    """mmhand_tpu ``ConvNormRelu``: pad -> conv -> norm -> relu."""
    if zero_pad_in_conv:
        conv = [strided_conv(in_features, features, kernel, stride,
                             padding=pad, use_bias=norm.use_bias)]
    else:
        conv = pad_conv(in_features, features, kernel, stride, pad,
                        pad_mode, use_bias=norm.use_bias)
    return [*conv, norm_layer(norm, features), nn.ReLU(True)]


# flax's truncated normal draws within 2 standard deviations and divides
# its scale by this, the standard deviation of N(0, 1) truncated there
_TRUNC_STD = 0.87962566103423978
_TRANSPOSED = (nn.ConvTranspose2d, nn.ConvTranspose3d)


def init_lecun_normal(net: nn.Module, generator: torch.Generator
                      ) -> nn.Module:
    """flax's default init: every conv, conv-transpose and linear kernel
    from a normal of variance 1 / fan_in truncated at 2 standard deviations
    (``lecun_normal``; a conv-transpose's fan_in is in * taps, as its flax
    kernel's), every bias 0."""
    # the inverse normal CDF of a uniform draw on [cdf(-2), cdf(2)], the
    # algorithm of nn.init.trunc_normal_, which takes ~10x longer on the CPU
    edge = math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        for m in net.modules():
            if not isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)
                              + _TRANSPOSED):
                continue
            w = m.weight
            fan_in = (w.shape[0] * w[0, 0].numel()
                      if isinstance(m, _TRANSPOSED) else w[0].numel())
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w.uniform_(-edge, edge, generator=generator)
            w.erfinv_().mul_(std * math.sqrt(2.0))
            w.clamp_(-2 * std, 2 * std)
            if m.bias is not None:
                m.bias.zero_()
    return net


INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")


def weight_fans(m: nn.Module) -> tuple[int, int, int]:
    """(fan_in, fan_out, output features) of a conv, conv-transpose or
    linear weight in mmhand_tpu's layout: a ConvTranspose2d weight
    (in, out, kh, kw) has fan_in in * kh * kw, as mmhand_tpu's UpConv kernel
    (torch's ``_calculate_fan_in_and_fan_out`` would give out * kh * kw)."""
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):
        cin, cout = w.shape[0], w.shape[1]
    else:
        cout, cin = w.shape[0], w.shape[1]
    taps = w[0, 0].numel() if w.ndim == 4 else 1
    return cin * taps, cout * taps, cout


def _orthogonal(m: nn.Module, generator: Optional[torch.Generator]) -> None:
    """A semi-orthogonal weight whose rows are the output features, as
    mmhand_tpu's (torch's ``orthogonal_``, gain 1, on the (out, rest)
    matrix; a ConvTranspose2d's rows are its dim 1)."""
    w = m.weight
    _, _, cout = weight_fans(m)
    rest = w.numel() // cout
    a = torch.randn(max(cout, rest), min(cout, rest), generator=generator,
                    dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))  # the unique decomposition
    q = q.T if cout < rest else q          # (cout, rest)
    if isinstance(m, nn.ConvTranspose2d):
        q = q.reshape(cout, w.shape[0], *w.shape[2:]).transpose(0, 1)
    w.copy_(q.reshape(w.shape))


def init_weights(net: nn.Module, init_type: str = "normal",
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw every conv, conv-transpose, linear and norm parameter of ``net``
    (reference models/network_utils.py:12-72, mmhand_tpu/models/layers.py
    ``apply_init_type``).  Biases are 0 and BatchNorm scales N(1, 0.02)
    whatever ``init_type``; it picks the conv and linear weights' draw:

    normal:     N(0, 0.02)
    xavier:     N(0, 0.02 sqrt(2 / (fan_in + fan_out)))
    kaiming:    N(0, sqrt(2 / fan_in))
    orthogonal: semi-orthogonal, gain 1, rows the output features

    with the fans of ``weight_fans``."""
    if init_type not in INIT_TYPES:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                if init_type == "orthogonal":
                    _orthogonal(m, generator)
                else:
                    fan_in, fan_out, _ = weight_fans(m)
                    std = {"normal": 0.02,
                           "xavier": 0.02 * (2.0 / (fan_in + fan_out)) ** 0.5,
                           "kaiming": (2.0 / fan_in) ** 0.5}[init_type]
                    m.weight.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.normal_(1.0, 0.02, generator=generator)
                m.bias.zero_()
    return net
