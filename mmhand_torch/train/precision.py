"""Dynamic loss scaling for float16 training (counterpart of
mmhand_tpu/train/precision.py; reference models/MMHandModel.py:294-308, APEX
amp O1 with three losses and the cross-rank overflow vote).

* one scaler per loss: G, D_PP and D_PB (amp ``num_losses=3``, reference
  :99-108);
* each loss is multiplied by its scale before backward and the gradients
  are multiplied by 1/scale after; a non-finite unscaled gradient raises the
  phase's overflow flag, which is OR-voted across ranks;
* the flag is sticky within a step: an overflow skips that phase's
  ``optimizer.step()`` and every later one of the step (reference
  optimize_parameters :315-328);
* a scale starts at 2^16, halves on overflow but never below 1, and doubles
  after 2000 clean steps in a row.

These are plain functions on tensors, not ``torch.amp.GradScaler``:
GradScaler has no floor at 1 and no flag that outlives one optimizer, so it
is another algorithm.  Scales are powers of two, so scaling and unscaling a
finite value is exact.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INIT_SCALE = 2.0 ** 16
BACKOFF = 0.5
GROWTH = 2.0
GROWTH_INTERVAL = 2000
SCALERS = ("g", "d_pp", "d_pb")


class LossScaleState(NamedTuple):
    scale: torch.Tensor         # f32 0-d, a power of two
    growth_count: torch.Tensor  # int32 0-d: clean steps in a row


def init_scale(init: float = INIT_SCALE, device="cpu") -> LossScaleState:
    return LossScaleState(torch.tensor(init, dtype=torch.float32, device=device),
                          torch.zeros((), dtype=torch.int32, device=device))


def init_scales(device="cpu") -> dict[str, LossScaleState]:
    """The three per-loss scalers (reference MMHandModel.py:103-108)."""
    return {k: init_scale(device=device) for k in SCALERS}


def grads_overflow(grads: torch.Tensor) -> torch.Tensor:
    """True (0-d bool) iff ``grads`` holds a non-finite value."""
    return ~torch.isfinite(grads).all()


def unscale_(grads: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    """``grads *= 1 / scale`` in place, as mmhand_tpu's ``unscale``."""
    return grads.mul_(1.0 / state.scale)


def update_scale(s: LossScaleState, overflow: torch.Tensor) -> LossScaleState:
    """Back off on overflow (floored at 1), grow after GROWTH_INTERVAL clean
    steps in a row."""
    grew = s.growth_count + 1 >= GROWTH_INTERVAL
    scale = torch.where(overflow, torch.clamp(s.scale * BACKOFF, min=1.0),
                        torch.where(grew, s.scale * GROWTH, s.scale))
    count = torch.where(overflow | grew, torch.zeros_like(s.growth_count),
                        s.growth_count + 1)
    return LossScaleState(scale, count)
