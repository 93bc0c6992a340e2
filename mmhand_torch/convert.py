"""mmhand_tpu network variables -> mmhand_torch state_dicts.

The exact inverses of ``convert_generator`` and ``convert_discriminator`` in
tools/convert_mmhand_torch.py, of ``convert_resnet_generator`` and
``convert_unet_generator`` in tools/convert_baselines_torch.py, of
mmhand_tpu's ``load_pose_resnet_state_dict``, and of the npz loaders of
mmhand_tpu's Inception-v3 (``load_inception_npz``) and CPM nets
(``load_cpm_state_dict``); and the same maps for the PATN2 generator and the
PatchGAN discriminators of mmhand_tpu's baseline zoo, which no tool
converts:

  conv        HWIO -> OIHW
  conv-transpose  (kh, kw, I, O) -> (I, O, kh, kw), then both spatial axes
              flipped (undoes the converter's flip-then-transpose)
  batchnorm   scale/bias -> weight/bias; batch_stats mean/var ->
              running_mean/running_var

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

from collections.abc import Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    # a writable C-order copy: jax arrays come back read-only, and the
    # conv-transpose flip is a negative-stride view
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _conv(p: dict) -> dict:
    out = {"weight": _tensor(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))}
    if "bias" in p:
        out["bias"] = _tensor(p["bias"])
    return out


def _convt(p: dict) -> dict:
    w = np.transpose(np.asarray(p["kernel"]), (2, 3, 0, 1))[:, :, ::-1, ::-1]
    out = {"weight": _tensor(w)}
    if "bias" in p:
        out["bias"] = _tensor(p["bias"])
    return out


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
