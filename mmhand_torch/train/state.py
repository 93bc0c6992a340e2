"""Networks, optimizers, pools and losses of the GAN trainer (counterpart of
mmhand_tpu/train/state.py and of ``build_system`` in mmhand_tpu/train/loop.py).

The reference trainer (reference models/MMHandModel.py:26-384) holds three
networks, three Adam optimizers, two image pools and the loss modules as
object state; ``MMHandSystem`` holds the same, on one device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch
from torch import nn

from mmhand_torch.config import Config
from mmhand_torch.losses.perceptual import L1PlusPerceptual
from mmhand_torch.models.discriminator import Discriminator
from mmhand_torch.models.generator import Generator
from mmhand_torch.models.layers import NormConfig, init_weights
from mmhand_torch.models.vgg import VGG19Features, load_vgg19_npz
from mmhand_torch.train.pool import PoolState, pool_init

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """PrecisionConfig.compute_dtype -> the autocast type, None for f32."""
    return _COMPUTE_DTYPES.get(name)


def _place(net: nn.Module, device) -> nn.Module:
    return net.to(device=device, memory_format=torch.channels_last)


def build_generator(cfg: Config, device="cuda",
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
    return _place(init_weights(g, m.init_type, rng), device)


def build_discriminator(cfg: Config, input_nc: int, device="cuda",
                        seed: int = 0) -> Discriminator:
    """A configured Discriminator on ``input_nc`` channels, its weights drawn
    on the CPU from ``seed``, moved to ``device`` as channels_last."""
    m = cfg.model
    d = Discriminator(input_nc, ndf=m.ndf, n_blocks=m.n_layers_d,
                      n_downsampling=m.d_n_downsampling,
                      norm=NormConfig(kind=m.norm), use_dropout=m.use_dropout_d,
                      pad_mode=m.padding_type,
                      compute_dtype=compute_dtype(cfg.precision.compute_dtype))
    return _place(init_weights(d, m.init_type,
                               torch.Generator().manual_seed(seed)), device)


def random_vgg(truncate_at: int, seed: int,
               dtype: Optional[torch.dtype]) -> VGG19Features:
    """VGG features with random weights: kernels ~ N(0, 1/fan_in), the
    variance of flax's lecun_normal default, biases 0."""
    vgg = VGG19Features(truncate_at, compute_dtype=dtype)
    rng = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in vgg.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=rng)
                m.bias.zero_()
    return vgg


@dataclasses.dataclass
class MMHandSystem:
    """Everything the train step reads and updates."""

    config: Config
    generator: Generator
    d_pb: Discriminator          # on cat(image, target heatmaps), 24 channels
    d_pp: Discriminator          # on cat(image, source image), 6 channels
    opt_g: torch.optim.Adam
    opt_d_pb: torch.optim.Adam
    opt_d_pp: torch.optim.Adam
    pool_pb: PoolState
    pool_pp: PoolState
    l1_loss: Optional[L1PlusPerceptual]  # None: --L1_type origin
    pool_rng: torch.Generator    # swap coins and slots, on the device
    step: int = 0


def _adam(net: nn.Module, cfg: Config) -> torch.optim.Adam:
    """torch.optim.Adam as the reference's three (MMHandModel.py:90-98); the
    loop sets the learning rate of each epoch."""
    return torch.optim.Adam(net.parameters(), lr=cfg.optim.lr,
                            betas=(cfg.optim.beta1, cfg.optim.beta2), eps=1e-8)


def build_system(cfg: Config, device="cuda", *, vgg_npz: Optional[str] = None,
                 seed: Optional[int] = None) -> MMHandSystem:
    """G, D_PB and D_PP with weights drawn from ``seed`` (``cfg.data.seed``
    when None), three Adams, two empty pools in the compute dtype, and the
    L1 + perceptual loss with the VGG of ``vgg_npz``, or random weights and
    a warning."""
    if cfg.precision.loss_scaling:
        raise NotImplementedError(
            "PrecisionConfig.loss_scaling (fp16 GradScalers) is not ported to "
            "mmhand_torch yet")
    device = torch.device(device)
    seed = cfg.data.seed if seed is None else seed
    m, lc = cfg.model, cfg.loss
    dtype = compute_dtype(cfg.precision.compute_dtype)
    g = build_generator(cfg, device, seed=seed)
    d_pb = build_discriminator(cfg, m.d_pb_input_nc, device, seed=seed + 1)
    d_pp = build_discriminator(cfg, m.d_pp_input_nc, device, seed=seed + 2)

    l1_loss = None
    if lc.l1_type != "origin":
        if vgg_npz:
            vgg = VGG19Features(lc.perceptual_layers, compute_dtype=dtype)
            vgg.load_state_dict(load_vgg19_npz(vgg_npz, lc.perceptual_layers))
        else:
            warnings.warn(
                "perceptual loss running with RANDOM VGG19 weights (a "
                "random-projection loss, structurally valid but NOT the "
                "reference's ImageNet-VGG perceptual term; pass --vgg_npz "
                "converted weights for parity)", stacklevel=2)
            vgg = random_vgg(lc.perceptual_layers, seed + 3, dtype)
        l1_loss = L1PlusPerceptual(
            _place(vgg, device), lambda_l1=lc.lambda_a,
            lambda_perceptual=lc.lambda_b, percep_is_l1=lc.percep_is_l1)

    size, pool = m.fine_size, cfg.optim.pool_size
    pool_dtype = dtype or torch.float32
    return MMHandSystem(
        config=cfg, generator=g, d_pb=d_pb, d_pp=d_pp,
        opt_g=_adam(g, cfg), opt_d_pb=_adam(d_pb, cfg),
        opt_d_pp=_adam(d_pp, cfg),
        pool_pb=pool_init(pool, (size, size, m.d_pb_input_nc), pool_dtype,
                          device),
        pool_pp=pool_init(pool, (size, size, m.d_pp_input_nc), pool_dtype,
                          device),
        l1_loss=l1_loss,
        pool_rng=torch.Generator(device=device).manual_seed(seed))
