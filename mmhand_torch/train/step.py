"""Generator steps (counterpart of mmhand_tpu/train/step.py; eval only)."""

from __future__ import annotations

import torch

from mmhand_torch.models.generator import Generator


def make_eval_step(generator: Generator):
    """Generator-only forward for aug/eval (reference MMHandModel.test
    :223-230, aug.py:49-53): batch dict of NHWC tensors -> (B, H, W, 3)
    float32 fakes, in eval mode under ``torch.inference_mode``."""

    def eval_step(batch: dict) -> torch.Tensor:
        generator.eval()
        with torch.inference_mode():
            g_in = (batch["H1"],
                    torch.cat([batch["P1"], batch["P2"]], dim=-1),
                    torch.cat([batch["D1"], batch["D2"]], dim=-1))
            return generator(g_in)

    return eval_step
