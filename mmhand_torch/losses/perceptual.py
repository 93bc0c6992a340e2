"""L1 + VGG19 perceptual loss (counterpart of mmhand_tpu/losses/perceptual.py;
reference losses/L1_plus_perceptualLoss.py:11-75):

    total = lambda_A * L1(fake, real)
          + lambda_B * dist(VGG19[:k](renorm(fake)), VGG19[:k](renorm(real)))

where dist is L1 (``percep_is_l1``) or MSE, and no gradient flows through the
real branch.
"""

from __future__ import annotations

import torch
from torch import nn

from mmhand_torch.models.vgg import VGG19Features, imagenet_renorm


class L1PlusPerceptual(nn.Module):
    """Holds the frozen VGG features; returns (total, l1, percep).  When both
    lambdas are zero it returns zeros and computes nothing (reference
    :33-35)."""

    def __init__(self, vgg: VGG19Features, lambda_l1: float = 10.0,
                 lambda_perceptual: float = 10.0, percep_is_l1: bool = True):
        super().__init__()
        self.vgg = vgg.requires_grad_(False).eval()
        self.lambda_l1 = lambda_l1
        self.lambda_perceptual = lambda_perceptual
        self.percep_is_l1 = percep_is_l1

    def forward(self, fake: torch.Tensor, real: torch.Tensor):
        """Args are NHWC images in [-1, 1]."""
        if self.lambda_l1 == 0 and self.lambda_perceptual == 0:
            z = torch.zeros((), dtype=torch.float32, device=fake.device)
            return z, z, z
        loss_l1 = (fake - real).abs().mean() * self.lambda_l1
        f_fake = self.vgg(imagenet_renorm(fake))
        with torch.no_grad():
            f_real = self.vgg(imagenet_renorm(real))
        diff = f_fake - f_real
        dist = diff.abs() if self.percep_is_l1 else diff ** 2
        percep = dist.mean() * self.lambda_perceptual
        return loss_l1 + percep, loss_l1, percep
