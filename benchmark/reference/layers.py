"""Plain PyTorch layers of the reference: float32, no kernels of the program.

* ``QConv2d``, ``QConvTranspose2d``, ``QLinear``: torch's layers; with
  ``quant`` set (``set_quant``), the input and the weight of each forward
  pass through it first, and the output's gradient is rounded to float8
  e5m2: the control's lower precision.
* ``BatchNorm``: train mode normalizes with the batch's mean and biased
  variance, worked out with torch's own mean, and folds them into the
  running statistics (momentum 0.1) unless ``update_running_stats`` is
  off; eval mode uses the running statistics.
* ``MaskDropout``: dropout with p 0.5 whose masks come, in call order, from
  a ``MaskSource`` that holds what the measured program drew.
* ``fp8``: the control's precision: a layer's input and weight rounded to
  float8 e4m3 and the gradient of its output to float8 e5m2, each under a
  per-tensor scale.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

def _round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under a per-tensor scale that
    maps its largest magnitude to the format's largest, then scaled back."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """A layer's input or weight in float8 e4m3; the gradient passes
    through unchanged."""
    return x + (_round_fp8(x.detach(), torch.float8_e4m3fn) - x).detach()


class _Fp8Grad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to float8 e5m2, as
    an fp8 training recipe feeds a layer's backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad, torch.float8_e5m2)


class _Quant:
    """With ``quant`` set, the layer's input and weight pass through it, and
    the gradient of its output through float8 e5m2."""

    quant: Optional[Callable] = None

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.quant is None else self.quant(t)

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.quant is None else _Fp8Grad.apply(y)


class QConv2d(_Quant, nn.Conv2d):
    def forward(self, x):
        return self._out(self._conv_forward(self._q(x), self._q(self.weight),
                                            self.bias))


class QConvTranspose2d(_Quant, nn.ConvTranspose2d):
    def forward(self, x):
        return self._out(F.conv_transpose2d(
            self._q(x), self._q(self.weight), self.bias, self.stride,
            self.padding, self.output_padding, self.groups, self.dilation))


class QLinear(_Quant, nn.Linear):
    def forward(self, x):
        return self._out(F.linear(self._q(x), self._q(self.weight),
                                  self.bias))


def set_quant(net: nn.Module, quant: Optional[Callable]) -> nn.Module:
    for m in net.modules():
        if isinstance(m, _Quant):
            m.quant = quant
    return net


class BatchNorm(nn.BatchNorm2d):
    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.update_running_stats = True

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        if self.update_running_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        y = (x - mean[:, None, None]) * torch.rsqrt(var + self.eps)[
            :, None, None]
        return y * self.weight[:, None, None] + self.bias[:, None, None]


@contextlib.contextmanager
def frozen_running_stats(*nets: nn.Module):
    bns = [m for net in nets for m in net.modules()
           if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_running_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_running_stats = True


class MaskSource:
    """The dropout masks of a run, by module name, in call order; with
    ``rows`` only the first ``rows`` samples of each."""

    def __init__(self, masks: dict, rows: Optional[int] = None):
        self.masks = masks
        self.rows = rows
        self.used = defaultdict(int)

    def next(self, name: str, like: torch.Tensor) -> torch.Tensor:
        i = self.used[name]
        self.used[name] += 1
        mask = self.masks[name][i]
        if callable(mask):
            mask = mask(like.device)
        if self.rows is not None:
            mask = mask[:self.rows]
        return mask.to(device=like.device, dtype=like.dtype)


class MaskDropout(nn.Module):
    """Dropout of p 0.5 with the masks of a ``MaskSource``."""

    def __init__(self):
        super().__init__()
        self.key = ""
        self.source: Optional[MaskSource] = None

    def forward(self, x):
        if not self.training:
            return x
        return x * self.source.next(self.key, x) * 2.0


def set_masks(nets: dict, source: MaskSource) -> None:
    """Give every MaskDropout of ``nets`` ({prefix: net}) the source and
    its key ``<prefix>.<module name>``."""
    for prefix, net in nets.items():
        for name, m in net.named_modules():
            if isinstance(m, MaskDropout):
                m.key = f"{prefix}.{name}"
                m.source = source


def adam_step(params, grads, state: dict, lr: float, betas, eps: float
              ) -> None:
    """torch.optim.Adam's update, written out: moments, bias corrections,
    then p -= lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps)."""
    b1, b2 = betas
    state["t"] = t = state.get("t", 0) + 1
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(params, grads)):
            m, v = state.setdefault(i, (torch.zeros_like(p),
                                        torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / bc2 ** 0.5).add_(eps)
            p.addcdiv_(m, denom, value=-lr / bc1)


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
