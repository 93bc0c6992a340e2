"""mmhand_tpu generator variables -> mmhand_torch ``Generator`` state_dict.

The exact inverse of ``convert_generator`` in tools/convert_mmhand_torch.py:

  conv        HWIO -> OIHW
  conv-transpose  (kh, kw, I, O) -> (I, O, kh, kw), then both spatial axes
              flipped (undoes the converter's flip-then-transpose)
  batchnorm   scale/bias -> weight/bias; batch_stats mean/var ->
              running_mean/running_var

The Sequential indices follow ``models.generator``: a stem is
[pad, conv, bn, relu] then [conv, bn, relu] per downsampling; a PATBlock
stream is [pad?, conv, bn, relu, dropout?, pad?, conv, bn?]; the up path is
[convT, bn, relu] per level, then [pad, conv].  Batch norm only, as the
converter.
"""

from __future__ import annotations

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


def generator_state_dict_from_jax(variables: dict, *, use_dropout: bool = True,
                                  pad_mode: str = "reflect"
                                  ) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a mmhand_tpu Generator (numpy or jax
    arrays) -> state_dict of the mmhand_torch Generator built with the same
    ``use_dropout`` and PATBlock ``pad_mode``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    def put(prefix: str, leaves: dict) -> None:
        sd.update({f"{prefix}.{k}": v for k, v in leaves.items()})

    def bn(*path):
        p, s = params, stats
        for seg in path:
            p, s = p[seg], s[seg]
        return _bn(p, s)

    n_down = sum(1 for k in params if k.startswith("stream1_down"))
    for s in (1, 2, 3):
        prefix = f"stream{s}_down"
        put(f"{prefix}.1", _conv(params[f"stream{s}_in"]["PadConv_0"]))
        put(f"{prefix}.2", bn(f"stream{s}_in", "Norm_0", "BatchNorm_0"))
        for d in range(n_down):
            node = f"stream{s}_down{d}"
            put(f"{prefix}.{4 + 3 * d}",
                _conv(params[node]["StridedConv_0"]["Conv_0"]))
            put(f"{prefix}.{5 + 3 * d}", bn(node, "Norm_0", "BatchNorm_0"))

    # PATBlock streams: the zero-padded conv pads itself, with no pad layer
    p = 0 if pad_mode == "zero" else 1
    second_conv = 2 * p + 3 + int(use_dropout)
    n_blocks = sum(1 for k in params if k.startswith("att"))
    for b in range(n_blocks):
        for snum in (1, 2, 3):
            node = params[f"att{b}"][f"stream{snum}"]
            prefix = f"att.{b}.conv_block_stream{snum}"
            put(f"{prefix}.{p}", _conv(node["ConvNormRelu_0"]["PadConv_0"]))
            put(f"{prefix}.{p + 1}", bn(f"att{b}", f"stream{snum}",
                                        "ConvNormRelu_0", "Norm_0",
                                        "BatchNorm_0"))
            put(f"{prefix}.{second_conv}", _conv(node["PadConv_0"]))
            if "Norm_0" in node:  # the image stream's trailing norm
                put(f"{prefix}.{second_conv + 1}",
                    bn(f"att{b}", f"stream{snum}", "Norm_0", "BatchNorm_0"))

    for d in range(n_down):
        put(f"stream1_up.{3 * d}", _convt(params[f"up{d}"]))
        put(f"stream1_up.{3 * d + 1}", bn(f"up{d}_norm", "BatchNorm_0"))
    put(f"stream1_up.{3 * n_down + 1}", _conv(params["out_conv"]))
    return sd
