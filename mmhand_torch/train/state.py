"""Network construction (counterpart of the generator part of
mmhand_tpu/train/state.py)."""

from __future__ import annotations

from typing import Optional

import torch

from mmhand_torch.config import Config
from mmhand_torch.models.generator import Generator
from mmhand_torch.models.layers import NormConfig, init_weights

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """PrecisionConfig.compute_dtype -> the autocast type, None for f32."""
    return _COMPUTE_DTYPES.get(name)


def build_generator(cfg: Config, device="cpu",
                    seed: Optional[int] = None) -> Generator:
    """The configured Generator, its weights drawn on the CPU from ``seed``
    (``cfg.data.seed`` when None), moved to ``device`` as channels_last."""
    m = cfg.model
    g = Generator(input_nc=m.g_input_nc, output_nc=m.output_nc, ngf=m.ngf,
                  n_blocks=m.g_n_blocks, n_downsampling=m.g_n_downsampling,
                  norm=NormConfig(kind=m.norm), use_dropout=m.use_dropout_g,
                  pad_mode=m.padding_type,
                  compute_dtype=compute_dtype(cfg.precision.compute_dtype))
    rng = torch.Generator().manual_seed(cfg.data.seed if seed is None else seed)
    init_weights(g, m.init_type, rng)
    return g.to(device=device, memory_format=torch.channels_last)
