"""Declarative configuration for mmhand_torch.

The same dataclass tree and CLI bridge as ``mmhand_tpu/config.py``, so one
command line drives either package: field names keep the reference flag names
(``--batchSize`` -> batch_size, etc.) and ``add_cli_args``/``from_cli_args``
are the argparse bridge.  Parsing has no side effects.

The TPU lowering knobs of ``ModelConfig`` (``reflect_impl``, ``head_impl``,
``stem_impl``, ``down_impl``, ``upconv_shuffle``, ``bn_stats*``,
``dstem_split``, ``g_stem_fused``, ``g_remat``) are accepted and ignored: the
port runs the plain operation for each of them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs (reference options/base_options.py:28-141)."""

    # channel counts: image / pose-heatmaps / depth-as-rgb
    h_input_nc: int = 3      # --H_input_nc
    p_input_nc: int = 21     # --P_input_nc (21 keypoints)
    d_input_nc: int = 3      # --D_input_nc
    output_nc: int = 3       # --output_nc
    ngf: int = 64            # --ngf
    ndf: int = 64            # --ndf
    n_layers_d: int = 3      # --n_layers_D (resnet blocks in D)
    g_n_blocks: int = 9      # hardcoded n_blocks=9 (reference MMHandModel.py:156)
    g_n_downsampling: int = 2  # --G_n_downsampling
    d_n_downsampling: int = 2  # --D_n_downsampling
    norm: str = "batch"      # --norm: batch | instance
    padding_type: str = "reflect"  # --padding_type
    init_type: str = "normal"      # --init_type
    use_dropout_g: bool = True     # not --no_dropout
    use_dropout_d: bool = True     # not --no_dropout_D
    fine_size: int = 256     # --fineSize

    # TPU lowering knobs of mmhand_tpu, accepted and ignored here.
    g_remat: bool = False
    reflect_impl: str = "padadd"
    head_impl: str = "d2s"
    stem_impl: str = "direct"
    down_impl: str = "direct"
    upconv_shuffle: str = "conv4"
    bn_stats: str = "reduce"
    bn_stats_min: int = 1 << 18
    dstem_split: bool = False
    g_stem_fused: int = 0

    @property
    def g_input_nc(self) -> tuple[int, int, int]:
        """Stream channel widths [image, 2x pose heatmaps, 2x depth-rgb]
        (reference MMHandModel.py:36-39)."""
        return (self.h_input_nc, 2 * self.p_input_nc, 2 * self.d_input_nc)

    @property
    def d_pb_input_nc(self) -> int:
        """D_PB sees cat(image, target heatmaps) (reference MMHandModel.py:50)."""
        return self.h_input_nc + self.p_input_nc

    @property
    def d_pp_input_nc(self) -> int:
        """D_PP sees cat(generated, source image) (reference MMHandModel.py:60)."""
        return self.h_input_nc + self.h_input_nc


@dataclass(frozen=True)
class LossConfig:
    """Loss weights and types (reference options/train_options.py:21-35)."""

    lambda_a: float = 10.0       # --lambda_A   (L1 weight)
    lambda_b: float = 10.0       # --lambda_B   (perceptual weight)
    lambda_gan: float = 5.0      # --lambda_GAN
    l1_type: str = "l1_plus_perL1"  # --L1_type: origin | l1_plus_perL1
    perceptual_layers: int = 3   # --perceptual_layers (VGG19 feature index)
    percep_is_l1: bool = True    # --percep_is_l1
    # The reference GANLoss is always BCE-with-logits; --no_lsgan is accepted
    # and ignored (reference models/network_utils.py:129-163).
    gan_mode: str = "vanilla"    # vanilla (bce-with-logits) | lsgan (mse)


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer + schedule (reference options/train_options.py:17-29)."""

    lr: float = 2e-4             # --lr
    beta1: float = 0.5           # --beta1
    beta2: float = 0.999         # torch.optim.Adam default
    niter: int = 500             # --niter (epochs at base lr)
    niter_decay: int = 200       # --niter_decay (epochs of linear decay)
    epoch_count: int = 1         # --epoch_count
    lr_policy: str = "lambda"    # --lr_policy: lambda | step | plateau
    lr_decay_iters: int = 50     # --lr_decay_iters (step policy)
    dg_ratio: int = 1            # --DG_ratio (D steps per G step)
    pool_size: int = 50          # --pool_size (replay buffer)


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection and the augmentation-ratio split
    (reference options/base_options.py:144-148, data/generic_dataset.py:96-128)."""

    dataset: str = "RHD"         # --dataset: RHD | STB | MMHand | synthetic
    dataroot: str = ""           # --dataroot
    batch_size: int = 8          # --batchSize (global batch)
    augmentation_ratio: float = 1.0  # --augmentation_ratio
    augmentation_method: str = "MM-Hand"  # --augmentation_method
    max_dataset_size: Optional[int] = None  # --max_dataset_size
    serial_batches: bool = False  # --serial_batches
    use_flip: bool = False       # --use_flip
    n_threads: int = 8           # --nThreads (host-side prep workers)
    seed: int = 49               # --seed
    pair_lst: str = ""           # --pairLst (MMHand CSV dataset)
    image_root: str = ""         # --imageroot (MMHand CSV dataset images)
    pose_root: str = ""          # --poseroot (MMHand CSV dataset .npy maps)
    sigma: float = 6.0           # GAN heatmap sigma (reference generic_dataset.py:145)


@dataclass(frozen=True)
class RunConfig:
    """Experiment bookkeeping (reference options/base_options.py:51-88,
    options/train_options.py:7-16)."""

    name: str = "experiment_name"    # --name
    checkpoints_dir: str = "./checkpoints"  # --checkpoints_dir
    phase: str = "train"             # --phase
    continue_train: bool = False     # --continue_train
    which_epoch: str = "latest"      # --which_epoch
    display_freq: int = 100          # --display_freq
    display_id: int = 0              # --display_id
    print_freq: int = 100            # --print_freq
    save_latest_freq: int = 5000     # --save_latest_freq
    save_epoch_freq: int = 1         # --save_epoch_freq


@dataclass(frozen=True)
class MeshConfig:
    """Data-parallel layout.  The reference's only parallel axis is data
    (NCCL DDP, reference options/base_options.py:171-178)."""

    data_axis: str = "data"
    num_devices: Optional[int] = None  # None => every visible device


@dataclass(frozen=True)
class PrecisionConfig:
    """Mixed precision.  ``compute_dtype`` 'bfloat16' runs the networks under
    ``torch.autocast`` in bf16 with f32 parameters; 'float32' runs plain f32."""

    compute_dtype: str = "bfloat16"   # matmul/conv compute dtype
    param_dtype: str = "float32"      # parameter + optimizer-state dtype
    loss_scaling: bool = False


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    run: RunConfig = field(default_factory=RunConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    is_train: bool = True

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------------
# CLI bridge with reference flag-name parity
# ----------------------------------------------------------------------------

_FLAG_MAP = [
    # (flag, dataclass path, type, help)
    ("--batchSize", "data.batch_size", int, "global batch size"),
    ("--fineSize", "model.fine_size", int, "image size"),
    ("--output_nc", "model.output_nc", int, "output channels"),
    ("--ngf", "model.ngf", int, "G base width"),
    ("--ndf", "model.ndf", int, "D base width"),
    ("--n_layers_D", "model.n_layers_d", int, "resnet blocks in D"),
    ("--H_input_nc", "model.h_input_nc", int, "image channels"),
    ("--P_input_nc", "model.p_input_nc", int, "pose heatmap channels"),
    ("--D_input_nc", "model.d_input_nc", int, "depth channels"),
    ("--G_n_downsampling", "model.g_n_downsampling", int, "G downsamples"),
    ("--D_n_downsampling", "model.d_n_downsampling", int, "D downsamples"),
    ("--norm", "model.norm", str, "batch|instance"),
    ("--padding_type", "model.padding_type", str, "reflect|replicate|zero"),
    ("--init_type", "model.init_type", str, "weight init"),
    ("--name", "run.name", str, "experiment name"),
    ("--checkpoints_dir", "run.checkpoints_dir", str, "checkpoint root"),
    ("--phase", "run.phase", str, "train/test"),
    ("--which_epoch", "run.which_epoch", str, "epoch label to load"),
    ("--display_freq", "run.display_freq", int, ""),
    ("--display_id", "run.display_id", int, ">0: live loss plot"),
    ("--print_freq", "run.print_freq", int, ""),
    ("--save_latest_freq", "run.save_latest_freq", int, ""),
    ("--save_epoch_freq", "run.save_epoch_freq", int, ""),
    ("--niter", "optim.niter", int, "epochs at base lr"),
    ("--niter_decay", "optim.niter_decay", int, "linear decay epochs"),
    ("--epoch_count", "optim.epoch_count", int, "starting epoch"),
    ("--beta1", "optim.beta1", float, "adam beta1"),
    ("--lr", "optim.lr", float, "adam lr"),
    ("--lr_policy", "optim.lr_policy", str, "lambda|step|plateau"),
    ("--lr_decay_iters", "optim.lr_decay_iters", int, ""),
    ("--DG_ratio", "optim.dg_ratio", int, "D steps per G step"),
    ("--pool_size", "optim.pool_size", int, "replay buffer size"),
    ("--lambda_A", "loss.lambda_a", float, "L1 weight"),
    ("--lambda_B", "loss.lambda_b", float, "perceptual weight"),
    ("--lambda_GAN", "loss.lambda_gan", float, "GAN loss weight"),
    ("--L1_type", "loss.l1_type", str, "origin|l1_plus_perL1"),
    ("--perceptual_layers", "loss.perceptual_layers", int, "VGG trunc index"),
    ("--dataset", "data.dataset", str, "RHD|STB|MMHand|synthetic"),
    ("--dataroot", "data.dataroot", str, "dataset root"),
    ("--augmentation_ratio", "data.augmentation_ratio", float, "train split ratio"),
    ("--augmentation_method", "data.augmentation_method", str, ""),
    ("--pairLst", "data.pair_lst", str, "pair CSV (MMHand dataset)"),
    ("--imageroot", "data.image_root", str, "image root (MMHand dataset)"),
    ("--poseroot", "data.pose_root", str, "pose-map root (MMHand dataset)"),
    ("--max_dataset_size", "data.max_dataset_size", int, "cap dataset size"),
    ("--seed", "data.seed", int, "rng seed"),
    ("--nThreads", "data.n_threads", int, "host data workers"),
]

_STORE_TRUE = [
    ("--no_dropout", "model.use_dropout_g", True),   # invert
    ("--no_dropout_D", "model.use_dropout_d", True),
    ("--serial_batches", "data.serial_batches", False),
    ("--use_flip", "data.use_flip", False),
    ("--continue_train", "run.continue_train", False),
    # --no_lsgan kept for CLI parity; the reference ignores it
    # (models/network_utils.py:141 always BCE) and so does the port.
    ("--no_lsgan", "loss._ignored_no_lsgan", False),
]


def add_cli_args(parser: argparse.ArgumentParser) -> None:
    for flag, _path, typ, hlp in _FLAG_MAP:
        parser.add_argument(flag, type=typ, default=None, help=hlp)
    for flag, _path, _inv in _STORE_TRUE:
        parser.add_argument(flag, action="store_true")
    parser.add_argument("--percep_is_l1", type=int, default=None)


def from_cli_args(args: argparse.Namespace, base: Optional[Config] = None) -> Config:
    cfg = base or Config()
    sections = {f.name: dataclasses.asdict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg) if f.name != "is_train"}
    for flag, path, _typ, _h in _FLAG_MAP:
        val = getattr(args, flag.lstrip("-"), None)
        if val is not None:
            sec, key = path.split(".")
            sections[sec][key] = val
    for flag, path, invert in _STORE_TRUE:
        if getattr(args, flag.lstrip("-"), False):
            sec, key = path.split(".")
            if key in sections.get(sec, {}):
                sections[sec][key] = not invert
    if getattr(args, "percep_is_l1", None) is not None:
        sections["loss"]["percep_is_l1"] = bool(args.percep_is_l1)
    return Config(
        model=ModelConfig(**sections["model"]),
        loss=LossConfig(**sections["loss"]),
        optim=OptimConfig(**sections["optim"]),
        data=DataConfig(**sections["data"]),
        run=RunConfig(**sections["run"]),
        mesh=MeshConfig(**sections["mesh"]),
        precision=PrecisionConfig(**sections["precision"]),
        is_train=cfg.is_train,
    )
