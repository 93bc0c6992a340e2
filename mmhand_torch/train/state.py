"""Networks, optimizers, pools and losses of the GAN trainer (counterpart of
mmhand_tpu/train/state.py and of ``build_system`` in mmhand_tpu/train/loop.py).

The reference trainer (reference models/MMHandModel.py:26-384) holds three
networks, three Adam optimizers, two image pools and the loss modules as
object state; ``MMHandSystem`` holds the same, on one device, for one rank
of a data-parallel run or for a single process.

Random streams: the nets' weights come from ``seed`` on every rank; the pool
generator and the global generator that draws dropout masks come from
``rank_seed(seed, rank)``, distinct per rank, as mmhand_tpu folds the replica
index into its key (mmhand_tpu/train/step.py:207-209).  Rank 0 of a run, and
a single process, draw from ``seed`` itself.  Neither stream can match
JAX's.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from mmhand_torch.config import Config
from mmhand_torch.losses.perceptual import L1PlusPerceptual
from mmhand_torch.models.discriminator import Discriminator
from mmhand_torch.models.generator import Generator
from mmhand_torch.models.layers import NormConfig, init_weights
from mmhand_torch.models.vgg import VGG19Features, load_vgg19_npz
from mmhand_torch.train.pool import PoolState, pool_init
from mmhand_torch.train.precision import LossScaleState, init_scales

_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """PrecisionConfig.compute_dtype -> the autocast type, None for f32."""
    return _COMPUTE_DTYPES.get(name)


def _place(net: nn.Module, device) -> nn.Module:
    return net.to(device=device, memory_format=torch.channels_last)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s pool and dropout streams."""
    return seed + 1_000_003 * rank


def build_generator(cfg: Config, device="cuda", seed: Optional[int] = None,
                    cross_rank: bool = False) -> Generator:
    """The configured Generator, its weights drawn on the CPU from ``seed``
    (``cfg.data.seed`` when None), moved to ``device`` as channels_last;
    ``cross_rank`` syncs its BatchNorm statistics over the ranks."""
    m = cfg.model
    g = Generator(input_nc=m.g_input_nc, output_nc=m.output_nc, ngf=m.ngf,
                  n_blocks=m.g_n_blocks, n_downsampling=m.g_n_downsampling,
                  norm=NormConfig(kind=m.norm, cross_rank=cross_rank),
                  use_dropout=m.use_dropout_g,
                  pad_mode=m.padding_type,
                  compute_dtype=compute_dtype(cfg.precision.compute_dtype))
    rng = torch.Generator().manual_seed(cfg.data.seed if seed is None else seed)
    return _place(init_weights(g, m.init_type, rng), device)


def build_discriminator(cfg: Config, input_nc: int, device="cuda",
                        seed: int = 0, cross_rank: bool = False
                        ) -> Discriminator:
    """A configured Discriminator on ``input_nc`` channels, its weights drawn
    on the CPU from ``seed``, moved to ``device`` as channels_last."""
    m = cfg.model
    d = Discriminator(input_nc, ndf=m.ndf, n_blocks=m.n_layers_d,
                      n_downsampling=m.d_n_downsampling,
                      norm=NormConfig(kind=m.norm, cross_rank=cross_rank),
                      use_dropout=m.use_dropout_d,
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


_NETS = ("generator", "d_pb", "d_pp")
_OPTS = ("opt_g", "opt_d_pb", "opt_d_pp")


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
    # {'g', 'd_pp', 'd_pb'} -> LossScaleState with
    # PrecisionConfig.loss_scaling, else None
    scales: Optional[dict] = None
    # this process's rank and the number of ranks; ``distributed``: the
    # step all-reduces gradients, metrics and BatchNorm moments
    rank: int = 0
    world: int = 1
    distributed: bool = False

    @property
    def device(self) -> torch.device:
        return self.pool_rng.device

    def state_dict(self) -> dict:
        """This rank's whole train state.  Under ``"rank"`` are the parts
        that differ between ranks (pools, random streams), as tensors; the
        rest is the same on every rank."""
        d = {name: getattr(self, name).state_dict() for name in _NETS + _OPTS}
        d["step"] = self.step
        d["scales"] = (None if self.scales is None else
                       {k: s._asdict() for k, s in self.scales.items()})
        own = {"pool_pb": self.pool_pb.images,
               "pool_pb_num": torch.tensor(self.pool_pb.num),
               "pool_pp": self.pool_pp.images,
               "pool_pp_num": torch.tensor(self.pool_pp.num),
               "rng_pool": self.pool_rng.get_state(),
               "rng_cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            own["rng_cuda"] = torch.cuda.get_rng_state(self.device)
        d["rank"] = own
        return d

    def load_state_dict(self, d: dict) -> None:
        """Restore what ``state_dict`` gave, on this system's device."""
        if (d["scales"] is None) != (self.scales is None):
            raise ValueError("the checkpoint's loss scaling differs from "
                             "PrecisionConfig.loss_scaling")
        own = d["rank"]
        for name in ("pool_pb", "pool_pp"):
            shape = getattr(self, name).images.shape
            if own[name].shape != shape:
                raise ValueError(f"{name}: the checkpoint holds "
                                 f"{tuple(own[name].shape)}, the system "
                                 f"{tuple(shape)}")
        for name in _NETS:
            getattr(self, name).load_state_dict(d[name])
        for name in _OPTS:
            opt = d[name]
            # Adam keeps a non-capturable step count on the CPU
            opt = {**opt, "state": {
                i: {k: v.cpu() if k == "step" else v for k, v in st.items()}
                for i, st in opt["state"].items()}}
            getattr(self, name).load_state_dict(opt)
        self.step = int(d["step"])
        if d["scales"] is not None:
            self.scales = {k: LossScaleState(**{
                f: v.to(self.device) for f, v in s.items()})
                for k, s in d["scales"].items()}
        for name in ("pool_pb", "pool_pp"):
            images = own[name].to(device=self.device,
                                  dtype=getattr(self, name).images.dtype)
            setattr(self, name, PoolState(images, int(own[f"{name}_num"])))
        self.pool_rng.set_state(own["rng_pool"].cpu())
        torch.set_rng_state(own["rng_cpu"].cpu())
        if self.device.type == "cuda":
            torch.cuda.set_rng_state(own["rng_cuda"].cpu(), self.device)


def _adam(net: nn.Module, cfg: Config) -> torch.optim.Adam:
    """torch.optim.Adam as the reference's three (MMHandModel.py:90-98); the
    loop sets the learning rate of each epoch."""
    return torch.optim.Adam(net.parameters(), lr=cfg.optim.lr,
                            betas=(cfg.optim.beta1, cfg.optim.beta2), eps=1e-8)


def build_system(cfg: Config, device="cuda", *, vgg_npz: Optional[str] = None,
                 seed: Optional[int] = None,
                 distributed: bool = False) -> MMHandSystem:
    """G, D_PB and D_PP with weights drawn from ``seed`` (``cfg.data.seed``
    when None), three Adams, two empty pools in the compute dtype, the loss
    scalers when PrecisionConfig.loss_scaling is on, and the L1 + perceptual
    loss with the VGG of ``vgg_npz``, or random weights and a warning.

    Seeds the global generator (dropout) with this rank's seed.
    ``distributed``: this process is one rank of the initialized
    torch.distributed group, and the BatchNorms sync over it."""
    device = torch.device(device)
    seed = cfg.data.seed if seed is None else seed
    rank, world = ((dist.get_rank(), dist.get_world_size()) if distributed
                   else (0, 1))
    torch.manual_seed(rank_seed(seed, rank))
    m, lc = cfg.model, cfg.loss
    dtype = compute_dtype(cfg.precision.compute_dtype)
    g = build_generator(cfg, device, seed=seed, cross_rank=distributed)
    d_pb = build_discriminator(cfg, m.d_pb_input_nc, device, seed=seed + 1,
                               cross_rank=distributed)
    d_pp = build_discriminator(cfg, m.d_pp_input_nc, device, seed=seed + 2,
                               cross_rank=distributed)

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
        pool_rng=torch.Generator(device=device).manual_seed(
            rank_seed(seed, rank)),
        scales=init_scales(device) if cfg.precision.loss_scaling else None,
        rank=rank, world=world, distributed=distributed)
