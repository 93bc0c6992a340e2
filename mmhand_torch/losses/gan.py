"""GAN loss on discriminator feature-map logits (counterpart of
mmhand_tpu/losses/gan.py).

The reference GANLoss is always BCE-with-logits against a scalar target
expanded to the prediction's shape; its ``use_lsgan`` flag is accepted and
ignored (reference models/network_utils.py:129-163).  ``mode="vanilla"`` is
that behaviour; ``mode="lsgan"`` the MSE variant the unused twin at
models/utils.py:117-151 honours.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gan_loss(logits: torch.Tensor, target_is_real: bool,
             mode: str = "vanilla") -> torch.Tensor:
    """Mean BCE-with-logits (or MSE) of a prediction against an all-real or
    all-fake target, in f32."""
    logits = logits.float()
    if mode == "vanilla":
        # BCEWithLogits(x, t) = softplus(x) - t x
        return F.softplus(-logits if target_is_real else logits).mean()
    if mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return ((logits - target) ** 2).mean()
    raise NotImplementedError(f"gan loss mode [{mode}]")
