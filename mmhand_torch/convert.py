"""mmhand_tpu network variables -> mmhand_torch state_dicts, and
mmhand_tpu train states -> the port's checkpoints (the end of this file).

The exact inverses of ``convert_generator`` and ``convert_discriminator`` in
tools/convert_mmhand_torch.py, of ``convert_resnet_generator`` and
``convert_unet_generator`` in tools/convert_baselines_torch.py, of
mmhand_tpu's ``load_pose_resnet_state_dict``, and of the npz loaders of
mmhand_tpu's Inception-v3 (``load_inception_npz``) and CPM nets
(``load_cpm_state_dict``); and the same maps for the PATN2 generator, the
PatchGAN discriminators of mmhand_tpu's baseline zoo and the hand3d nets,
which no tool converts to the port:

  conv        HWIO -> OIHW
  conv-transpose  (kh, kw, I, O) -> (I, O, kh, kw), then both spatial axes
              flipped (undoes the converter's flip-then-transpose)
  batchnorm   scale/bias -> weight/bias; batch_stats mean/var ->
              running_mean/running_var

The depth and voxel GAN nets (``models.voxel_nets``) name their modules
with the reference's torch keys, and mmhand_tpu names each flax module by
the same key with '.' -> '_' (``mmhand_tpu/models/voxel_nets.py``
``load_*_state_dict``), so their maps walk the port's own module tree.

The Sequential indices follow ``models.generator``: a stem is
[pad, conv, bn, relu] then [conv, bn, relu] per downsampling; a PATBlock
stream is [pad?, conv, bn, relu, dropout?, pad?, conv, bn?]; the up path is
[convT, bn, relu] per level, then [pad, conv].  A discriminator is
[pad, conv, bn, relu], [conv, bn, relu] per downsampling, then one
ResnetBlock per index whose ``conv_block`` is laid out as a PATBlock image
stream.  Batch norm only, as the converter.  The VGG features carry over
from HWIO kernels to the torch indices of ``models.vgg``.
"""

from __future__ import annotations

import functools
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _tensor(a) -> torch.Tensor:
    # a writable C-order copy: jax arrays come back read-only, and the
    # conv-transpose flip is a negative-stride view
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _conv(p: dict) -> dict:
    """HWIO (DHWIO) -> OIHW (OIDHW)."""
    k = np.asarray(p["kernel"])
    out = {"weight": _tensor(np.transpose(
        k, (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2))))}
    if "bias" in p:
        out["bias"] = _tensor(p["bias"])
    return out


def _convt(p: dict) -> dict:
    """(*spatial, I, O) -> (I, O, *spatial), every spatial axis flipped."""
    k = np.asarray(p["kernel"])
    spatial = k.ndim - 2
    w = np.transpose(k, (spatial, spatial + 1) + tuple(range(spatial)))
    out = {"weight": _tensor(w[(slice(None),) * 2 + (slice(None, None, -1),)
                               * spatial])}
    if "bias" in p:
        out["bias"] = _tensor(p["bias"])
    return out


def _dense(p: dict) -> dict:
    return {"weight": _tensor(np.asarray(p["kernel"]).T),
            "bias": _tensor(p["bias"])}


def _bn(params: dict, stats: dict) -> dict:
    return {"weight": _tensor(params["scale"]), "bias": _tensor(params["bias"]),
            "running_mean": _tensor(stats["mean"]),
            "running_var": _tensor(stats["var"]),
            "num_batches_tracked": torch.tensor(0, dtype=torch.long)}


class _Converted:
    """A port state_dict filled from one ``{"params", "batch_stats"}``
    tree."""

    def __init__(self, variables: dict):
        self.params = variables["params"]
        self.stats = variables["batch_stats"]
        self.sd: dict[str, torch.Tensor] = {}

    def put(self, prefix: str, leaves: dict) -> None:
        self.sd.update({f"{prefix}.{k}": v for k, v in leaves.items()})

    def bn(self, *path) -> dict:
        p, s = self.params, self.stats
        for seg in path:
            p, s = p[seg], s[seg]
        return _bn(p, s)


def _block_indices(use_dropout: bool, pad_mode: str) -> tuple[int, int]:
    """Sequential indices of the first and second conv of a residual stream
    [pad?, conv, bn, relu, dropout?, pad?, conv, bn?]: a zero-padded conv
    pads itself, with no pad layer."""
    p = 0 if pad_mode == "zero" else 1
    return p, 2 * p + 3 + int(use_dropout)


def generator_state_dict_from_jax(variables: dict, *, use_dropout: bool = True,
                                  pad_mode: str = "reflect"
                                  ) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a mmhand_tpu Generator (numpy or jax
    arrays) -> state_dict of the mmhand_torch Generator built with the same
    ``use_dropout`` and PATBlock ``pad_mode``.  The streams are those of the
    tree's ``stream<s>_in`` stems, so a PATN2Stream (two streams) converts
    the same way (``patn2_state_dict_from_jax``)."""
    b = _Converted(variables)
    params, put, bn = b.params, b.put, b.bn
    n_down = sum(1 for k in params if k.startswith("stream1_down"))
    streams = range(1, 1 + sum(1 for k in params
                               if k.startswith("stream") and k.endswith("_in")))
    p, second_conv = _block_indices(use_dropout, pad_mode)
    for s in streams:
        prefix = f"stream{s}_down"
        put(f"{prefix}.1", _conv(params[f"stream{s}_in"]["PadConv_0"]))
        put(f"{prefix}.2", bn(f"stream{s}_in", "Norm_0", "BatchNorm_0"))
        for d in range(n_down):
            node = f"stream{s}_down{d}"
            put(f"{prefix}.{4 + 3 * d}",
                _conv(params[node]["StridedConv_0"]["Conv_0"]))
            put(f"{prefix}.{5 + 3 * d}", bn(node, "Norm_0", "BatchNorm_0"))

    n_blocks = sum(1 for k in params if k.startswith("att"))
    for blk in range(n_blocks):
        for snum in streams:
            node = params[f"att{blk}"][f"stream{snum}"]
            prefix = f"att.{blk}.conv_block_stream{snum}"
            put(f"{prefix}.{p}", _conv(node["ConvNormRelu_0"]["PadConv_0"]))
            put(f"{prefix}.{p + 1}", bn(f"att{blk}", f"stream{snum}",
                                        "ConvNormRelu_0", "Norm_0",
                                        "BatchNorm_0"))
            put(f"{prefix}.{second_conv}", _conv(node["PadConv_0"]))
            if "Norm_0" in node:  # the image stream's trailing norm
                put(f"{prefix}.{second_conv + 1}",
                    bn(f"att{blk}", f"stream{snum}", "Norm_0", "BatchNorm_0"))

    for d in range(n_down):
        put(f"stream1_up.{3 * d}", _convt(params[f"up{d}"]))
        put(f"stream1_up.{3 * d + 1}", bn(f"up{d}_norm", "BatchNorm_0"))
    put(f"stream1_up.{3 * n_down + 1}", _conv(params["out_conv"]))
    return b.sd


# mmhand_tpu's PATN2Stream -> models.baselines.PATN2Stream
patn2_state_dict_from_jax = generator_state_dict_from_jax


def discriminator_state_dict_from_jax(variables: dict, *,
                                      use_dropout: bool = True,
                                      pad_mode: str = "reflect"
                                      ) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a mmhand_tpu Discriminator -> state_dict
    of the mmhand_torch Discriminator built with the same ``use_dropout`` and
    ResnetBlock ``pad_mode``; the number of downsamplings and blocks is read
    from the tree."""
    b = _Converted(variables)
    params, put, bn = b.params, b.put, b.bn
    put("1", _conv(params["in_conv"]["PadConv_0"]))
    put("2", bn("in_conv", "Norm_0", "BatchNorm_0"))
    n_down = sum(1 for k in params if k.startswith("down"))
    for d in range(n_down):
        put(f"{4 + 3 * d}", _conv(params[f"down{d}"]["StridedConv_0"]["Conv_0"]))
        put(f"{5 + 3 * d}", bn(f"down{d}", "Norm_0", "BatchNorm_0"))
    p, second_conv = _block_indices(use_dropout, pad_mode)
    n_blocks = sum(1 for k in params if k.startswith("res"))
    for r in range(n_blocks):
        node = params[f"res{r}"]
        prefix = f"{4 + 3 * n_down + r}.conv_block"
        put(f"{prefix}.{p}", _conv(node["ConvNormRelu_0"]["PadConv_0"]))
        put(f"{prefix}.{p + 1}", bn(f"res{r}", "ConvNormRelu_0", "Norm_0",
                                    "BatchNorm_0"))
        put(f"{prefix}.{second_conv}", _conv(node["PadConv_0"]))
        put(f"{prefix}.{second_conv + 1}", bn(f"res{r}", "Norm_0",
                                              "BatchNorm_0"))
    return b.sd


def vgg_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """mmhand_tpu ``VGG19Features`` params (``conv<i>`` -> HWIO kernel, bias)
    -> state_dict of the mmhand_torch ``VGG19Features`` (``<i>.weight`` OIHW,
    ``<i>.bias``)."""
    sd: dict[str, torch.Tensor] = {}
    for name, leaves in params.items():
        sd.update({f"{name.removeprefix('conv')}.{k}": v
                   for k, v in _conv(leaves).items()})
    return sd


def _named_tree(variables: dict, drop: tuple[str, ...] = ()
                ) -> dict[str, torch.Tensor]:
    """A flax tree whose module names are torch attribute names -> the torch
    state_dict: conv kernels HWIO -> OIHW, dense kernels transposed,
    scale -> weight, batch_stats mean/var -> running_mean/running_var.
    Path segments in ``drop`` (flax's own wrapper names) are left out."""
    sd: dict[str, torch.Tensor] = {}

    def walk(node, path, stats):
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + ([] if name in drop else [name]), stats)
                continue
            a = np.asarray(value)
            if stats:
                leaf = {"mean": "running_mean", "var": "running_var"}[name]
            elif name == "kernel":
                leaf = "weight"
                a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
            else:
                leaf = {"scale": "weight"}.get(name, name)
            sd[".".join(path + [leaf])] = _tensor(a)
            if leaf == "running_mean":
                sd[".".join(path + ["num_batches_tracked"])] = torch.tensor(
                    0, dtype=torch.long)

    walk(variables["params"], [], False)
    walk(variables.get("batch_stats", {}), [], True)
    return sd


def inception_state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of the mmhand_tpu Inception3 ->
    state_dict of ``models.inception.Inception3`` (torchvision keys)."""
    return _named_tree(variables)


def cpm_state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """``{"params"}`` of the mmhand_tpu Hpm2d or Hpm3d -> state_dict of the
    port's (the reference's keys: ``conv1_1.weight``, ``stage2.conv1.bias``,
    ``depth_fc_1.weight``)."""
    return _named_tree(variables, drop=("trunk", "Conv_0"))


def hpe_state_from_jax(state) -> dict:
    """An mmhand_tpu ``HPETrainState`` -> {"hpm2d", "hpm3d"}: the port's
    state_dicts of its ``params2d`` and ``params3d`` (None where the
    variant has no such net), to load into ``hpe.HPESystem``'s nets, and
    its ``step``."""
    out = {"step": int(np.asarray(state.step))}
    for name, params in (("hpm2d", state.params2d),
                         ("hpm3d", state.params3d)):
        out[name] = (None if params is None
                     else cpm_state_dict_from_jax({"params": params}))
    return out


def hand3d_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """``params`` of any mmhand_tpu hand3d net (HandSegNet, PoseNet2D,
    PosePrior, ViewpointNet, ColorHandPose3D, PosePriorNetwork) -> the
    state_dict of the port's twin in ``models.hand3d``: the TF scope names
    carry over (``conv1_1.conv.weight``, ``PosePrior.fc_rel0.weight``),
    conv kernels HWIO -> OIHW, Dense kernels [in, out] -> [out, in]."""
    return _named_tree({"params": params})


def resnet_generator_state_dict_from_jax(variables: dict, *,
                                         use_dropout: bool = False,
                                         pad_mode: str = "reflect"
                                         ) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a mmhand_tpu ResnetGenerator ->
    state_dict of ``models.baselines.ResnetGenerator``: the discriminator's
    stem, downsamplings and ResnetBlocks, then [convT, bn, relu] per level
    and [pad, conv, tanh]."""
    sd = discriminator_state_dict_from_jax(variables, use_dropout=use_dropout,
                                           pad_mode=pad_mode)
    b = _Converted(variables)
    params, put = b.params, b.put
    n_down = sum(1 for k in params if k.startswith("down"))
    first_up = 4 + 3 * n_down + sum(1 for k in params if k.startswith("res"))
    for d in range(n_down):
        put(f"{first_up + 3 * d}", _convt(params[f"up{d}"]))
        put(f"{first_up + 3 * d + 1}", b.bn(f"up{d}_norm", "BatchNorm_0"))
    put(f"{first_up + 3 * n_down + 1}", _conv(params["out_conv"]))
    return {**sd, **b.sd}


def unet_generator_state_dict_from_jax(variables: dict
                                       ) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a mmhand_tpu UnetGenerator ->
    state_dict of ``models.baselines.UnetGenerator``, whose nested
    ``model.`` Sequentials are the reference's: the outermost level is
    [downconv, sub, relu, convT, tanh], a middle one [leaky, downconv, bn,
    sub, relu, convT, bn], the innermost [leaky, downconv, relu, convT,
    bn]; a level's submodule sits at index 1 (outermost) or 3."""
    b = _Converted(variables)
    params, put, bn = b.params, b.put, b.bn
    n_mid = sum(1 for k in params if k.startswith("mid"))
    names = (["outer", "lvl1", "lvl2", "lvl4"]
             + [f"mid{i}" for i in reversed(range(n_mid))] + ["inner"])
    prefix = "model.model."
    for name in names:
        node = params[name]
        if name == "outer":
            put(f"{prefix}0", _conv(node["down"]))
            put(f"{prefix}3", _convt(node["up"]))
            prefix += "1.model."
        elif name == "inner":
            put(f"{prefix}1", _conv(node["down"]))
            put(f"{prefix}3", _convt(node["up"]))
            put(f"{prefix}4", bn(name, "up_norm", "BatchNorm_0"))
        else:
            put(f"{prefix}1", _conv(node["down"]))
            put(f"{prefix}2", bn(name, "down_norm", "BatchNorm_0"))
            put(f"{prefix}5", _convt(node["up"]))
            put(f"{prefix}6", bn(name, "up_norm", "BatchNorm_0"))
            prefix += "3.model."
    return b.sd


def nlayer_discriminator_state_dict_from_jax(variables: dict
                                             ) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a mmhand_tpu NLayerDiscriminator ->
    state_dict of ``models.baselines.NLayerDiscriminator``: [conv, leaky],
    then [conv, bn, leaky] per layer, then the head conv."""
    b = _Converted(variables)
    params = b.params
    b.put("0", _conv(params["conv0"]))
    n_layers = sum(1 for k in params if k.startswith("norm"))
    for n in range(1, n_layers + 1):
        b.put(f"{3 * n - 1}", _conv(params[f"conv{n}"]))
        b.put(f"{3 * n}", b.bn(f"norm{n}", "BatchNorm_0"))
    b.put(f"{3 * n_layers + 2}", _conv(params["head"]))
    return b.sd


def pixel_discriminator_state_dict_from_jax(variables: dict
                                            ) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a mmhand_tpu PixelDiscriminator ->
    state_dict of ``models.baselines.PixelDiscriminator``: [conv, leaky,
    conv, bn, leaky, conv]."""
    b = _Converted(variables)
    b.put("0", _conv(b.params["conv0"]))
    b.put("2", _conv(b.params["conv1"]))
    b.put("3", b.bn("norm1", "BatchNorm_0"))
    b.put("5", _conv(b.params["head"]))
    return b.sd


def pose_resnet_state_dict_from_jax(variables: dict
                                    ) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a mmhand_tpu PoseResNet -> the
    reference's torch state_dict, which ``models.baselines.PoseResNet``
    loads: the inverse of mmhand_tpu's ``load_pose_resnet_state_dict``."""
    b = _Converted(variables)
    params, put, bn = b.params, b.put, b.bn
    put("conv1", _conv(params["conv1"]))
    put("bn1", bn("bn1"))
    for name, node in params.items():
        if not name.startswith("layer"):
            continue
        stage, block = name.removeprefix("layer").split("_")
        prefix = f"layer{stage}.{block}"
        for c in range(1, 4):
            if f"conv{c}" in node:
                put(f"{prefix}.conv{c}", _conv(node[f"conv{c}"]))
                put(f"{prefix}.bn{c}", bn(name, f"bn{c}"))
        if "down_conv" in node:
            put(f"{prefix}.downsample.0", _conv(node["down_conv"]))
            put(f"{prefix}.downsample.1", bn(name, "down_bn"))
    i = 0
    while f"deconv{i}" in params:
        put(f"deconv_layers.{3 * i}", _convt(params[f"deconv{i}"]))
        put(f"deconv_layers.{3 * i + 1}", bn(f"deconv_bn{i}"))
        i += 1
    put("final_layer", _conv(params["final_layer"]))
    return b.sd


def _from_module_tree(variables: dict, net: nn.Module,
                      strip: str = "") -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` whose flax names are the torch module
    names of ``net`` (a skeleton on the meta device) with '.' -> '_' and
    ``strip`` removed from the front -> ``net``'s state_dict: conv kernels
    (D)HWIO -> OI(D)HW, conv-transpose kernels flipped to (I, O, ...),
    Dense [in, out] -> [out, in], BatchNorm scale/bias and mean/var."""
    b = _Converted(variables)
    for name, m in net.named_modules():
        flax = name.removeprefix(strip).replace(".", "_")
        if isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
            b.put(name, _convt(b.params[flax]))
        elif isinstance(m, (nn.Conv2d, nn.Conv3d)):
            b.put(name, _conv(b.params[flax]))
        elif isinstance(m, nn.Linear):
            b.put(name, _dense(b.params[flax]))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            b.put(name, b.bn(flax))
    return b.sd


def _skeleton(cls, **kwargs) -> nn.Module:
    """``cls`` on the meta device: its module names and types, no
    weights."""
    with torch.device("meta"):
        return cls(**kwargs)


def depth_generator_state_dict_from_jax(variables: dict
                                        ) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a mmhand_tpu DepthGenerator ->
    state_dict of ``models.voxel_nets.DepthGenerator`` (``linear``,
    ``models.<i>.0`` conv-transpose, ``models.<i>.1`` BatchNorm)."""
    from mmhand_torch.models.voxel_nets import DepthGenerator

    n_layer = sum(1 for k in variables["params"] if k.startswith("models_")
                  and k.endswith("_0"))
    return _from_module_tree(variables,
                             _skeleton(DepthGenerator, n_layer=n_layer))


def depth_discriminator_state_dict_from_jax(variables: dict
                                            ) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a mmhand_tpu DepthDiscriminator ->
    state_dict of ``models.voxel_nets.DepthDiscriminator`` (``encoder.0``,
    ``predictor.2``, ``hard_predictor.5`` ...)."""
    from mmhand_torch.models.voxel_nets import DepthDiscriminator

    return _from_module_tree(variables, _skeleton(DepthDiscriminator))


def voxel_generator_state_dict_from_jax(variables: dict
                                        ) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a mmhand_tpu VoxelGenerator ->
    state_dict of ``models.voxel_nets.VoxelGenerator``
    (``front_layers.0.block.0``, ``encoder_decoder.skip_res1.res_branch.0``
    ...)."""
    from mmhand_torch.models.voxel_nets import VoxelGenerator

    return _from_module_tree(variables, _skeleton(VoxelGenerator))


def voxel_discriminator_state_dict_from_jax(variables: dict
                                            ) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a mmhand_tpu VoxelDiscriminator ->
    state_dict of ``models.voxel_nets.VoxelDiscriminator``, whose blocks
    are ``models.models.<i>`` (mmhand_tpu's ``models_<i>``)."""
    from mmhand_torch.models.voxel_nets import VoxelDiscriminator

    return _from_module_tree(variables, _skeleton(VoxelDiscriminator),
                             strip="models.")


# ------------------------------------------------------------ train states
#
# An mmhand_tpu train state, as ``jax.device_get`` (or an orbax restore into
# mmhand_tpu's own template) gives it, -> the dict the port's
# ``CheckpointManager`` writes: the system's ``state_dict()``, its per-rank
# parts stacked over the ranks under ``"rank"``, and ``"world"``.  The
# optax states are ``chain(scale_by_adam, scale(-1))``: (ScaleByAdamState
# (count, mu, nu), EmptyState()).  mu and nu have the params' tree, and
# every step of the maps above is a permutation, a flip or a transpose of
# a leaf's elements, so the moments go through the params' own map.
# torch's Adam and optax's keep the same moments and take the same bias
# corrections and eps (added to sqrt(v_hat)), so the next step is the same
# up to rounding.  No random stream carries over (torch cannot draw JAX's
# numbers): the file says ``"rng": "fresh"``, and the port's systems seed
# their streams from the run's seed when they load it.


def _on_meta(make):
    """``make()`` on the meta device: module names and types, no weights."""
    with torch.device("meta"):
        return make()


def _adam_from_jax(opt_state, convert, net: nn.Module,
                   fresh: torch.optim.Optimizer) -> dict:
    """optax ``(ScaleByAdamState, EmptyState)`` -> the state_dict of a torch
    Adam over ``net.parameters()``, whose ``param_groups`` (lr, betas, eps)
    are those of ``fresh``, an Adam the port builds for ``net``.
    ``convert(tree)`` maps a params-shaped tree to ``net``'s state_dict."""
    adam = opt_state[0]
    mu, nu = convert(adam.mu), convert(adam.nu)
    step = float(np.asarray(adam.count))
    return {"state": {i: {"step": torch.tensor(step, dtype=torch.float32),
                          "exp_avg": mu[name], "exp_avg_sq": nu[name]}
                      for i, (name, _) in enumerate(net.named_parameters())},
            "param_groups": fresh.state_dict()["param_groups"]}


def train_state_from_jax(tree, cfg, world: int = 1) -> dict:
    """An mmhand_tpu ``MMHandTrainState`` -> what ``CheckpointManager``
    writes for the port's ``MMHandSystem`` of ``cfg``: G, D_PB and D_PP with
    their running statistics, their three Adams, the step, the loss scales
    (None where the run had none) and, per rank, the two pools in the
    compute dtype.  A state saved from a mesh holds a pool per replica (a
    leading axis of ``world``), which become the port's rank rows; a
    single-device state's pools are the one row of ``world`` 1."""
    from mmhand_torch.train.state import (
        compute_dtype,
        make_adam,
        make_discriminator,
        make_generator,
    )

    m = cfg.model
    gen = functools.partial(generator_state_dict_from_jax,
                            use_dropout=m.use_dropout_g,
                            pad_mode=m.padding_type)
    disc = functools.partial(discriminator_state_dict_from_jax,
                             use_dropout=m.use_dropout_d,
                             pad_mode=m.padding_type)
    out = {}
    for name, opt, state, to_sd, make in (
            ("generator", "opt_g", tree.g, gen, lambda: make_generator(cfg)),
            ("d_pb", "opt_d_pb", tree.d_pb, disc,
             lambda: make_discriminator(cfg, m.d_pb_input_nc)),
            ("d_pp", "opt_d_pp", tree.d_pp, disc,
             lambda: make_discriminator(cfg, m.d_pp_input_nc))):
        stats = state.batch_stats
        out[name] = to_sd({"params": state.params, "batch_stats": stats})
        net = _on_meta(make)
        # the moments' maps read the statistics for their structure only:
        # _adam_from_jax keeps the parameters' keys
        out[opt] = _adam_from_jax(
            getattr(tree, opt),
            lambda t: to_sd({"params": t, "batch_stats": stats}),
            net, make_adam(net, cfg))
    out["step"] = int(np.asarray(tree.step))
    out["scales"] = None if tree.scales is None else {
        k: {"scale": torch.tensor(float(np.asarray(s.scale)),
                                  dtype=torch.float32),
            "growth_count": torch.tensor(int(np.asarray(s.growth_count)),
                                         dtype=torch.int32)}
        for k, s in tree.scales.items()}
    dtype = compute_dtype(cfg.precision.compute_dtype) or torch.float32
    out["rank"] = {}
    for name in ("pool_pb", "pool_pp"):
        pool = getattr(tree, name)
        images = np.array(pool.images, np.float32)  # exact from bf16 / f16
        num = np.asarray(pool.num).astype(np.int64)
        if images.ndim == 4:  # a single-device state: no replica axis
            images, num = images[None], num[None]
        if images.shape[0] != world or num.shape != (world,):
            raise ValueError(
                f"{name}: the state holds {images.shape[0]} replicas' pools, "
                f"the export asks for world {world}")
        out["rank"][name] = torch.from_numpy(images).to(dtype)
        out["rank"][f"{name}_num"] = torch.from_numpy(num)
    out["world"] = world
    out["rng"] = "fresh"
    return out


def hpe_train_state_from_jax(tree, variant: str, world: int = 1,
                             cfg=None) -> dict:
    """An mmhand_tpu ``HPETrainState`` -> what ``CheckpointManager`` writes
    for the port's ``hpe.HPESystem`` of ``variant``: Hpm2d and Hpm3d (None
    where the variant has no such net), their Adams with the ``param_groups``
    of ``cfg`` (``Config()`` when None), and the step.  Nothing differs
    between ranks (``"rank"`` is empty); ``world`` is the run's rank
    count."""
    from mmhand_torch.config import Config
    from mmhand_torch.models.cpm import Hpm2d, Hpm3d
    from mmhand_torch.train.state import make_adam

    cfg = Config() if cfg is None else cfg
    nets = hpe_state_from_jax(tree)
    out = {"variant": variant, "step": nets["step"], "rank": {},
           "world": world, "rng": "fresh"}
    for name, opt, opt_state, make in (
            ("hpm2d", "opt2d", tree.opt2d, Hpm2d),
            ("hpm3d", "opt3d", tree.opt3d, Hpm3d)):
        out[name] = nets[name]
        if opt_state is None:
            out[opt] = None
            continue
        net = _on_meta(make)  # the names do not depend on Hpm3d's size
        out[opt] = _adam_from_jax(
            opt_state, lambda t: cpm_state_dict_from_jax({"params": t}),
            net, make_adam(net, cfg))
    return out


def hand3d_train_state_from_jax(tree, net: str,
                                variant: str = "proposed") -> dict:
    """An mmhand_tpu ``SubnetTrainState`` -> what ``CheckpointManager``
    writes for the port's ``hand3d.Hand3DSystem`` of ``net`` (and, for
    lifting, ``variant``): the subnet, its Adam and the step, for one
    rank."""
    from mmhand_torch.hand3d.system import make_adam, make_net

    module, para = _on_meta(lambda: make_net(net, variant))
    return {"net": net, "variant": variant, "step": int(np.asarray(tree.step)),
            "module": hand3d_state_dict_from_jax(tree.params),
            "opt": _adam_from_jax(tree.opt, hand3d_state_dict_from_jax,
                                  module, make_adam(module, para)),
            "rank": {}, "world": 1, "rng": "fresh"}
