"""What the drivers share: the data tree in the checkout's cache, the
program's Config from a cell's files, the benchmark's weights for the
program's nets, and the packed dropout masks."""

from __future__ import annotations

import math
from pathlib import Path

import torch
from torch import nn

from benchmark.traffic.tree import write_tree

CACHE_DIR = Path(__file__).resolve().parent.parent / ".cache"


def tree_root(n_items: int, size: int) -> str:
    """The cell's data tree, written on the first run in this checkout."""
    root = CACHE_DIR / f"block_tree_{n_items}_{size}"
    return write_tree(str(root), n_items, size)


def port_config(cell, seed: int, dataroot: str, is_train: bool = True):
    """The program's Config for the cell: the config file's model, loss,
    optimizer and precision sections, the traffic's data settings."""
    from mmhand_torch.config import (
        Config,
        DataConfig,
        LossConfig,
        ModelConfig,
        OptimConfig,
        PrecisionConfig,
        RunConfig,
    )

    c, t = cell.config, cell.traffic
    return Config(
        model=ModelConfig(**c.get("model", {})),
        loss=LossConfig(**c.get("loss", {})),
        optim=OptimConfig(**c.get("optim", {})),
        precision=PrecisionConfig(**c["precision"]),
        data=DataConfig(dataset="RHD", dataroot=dataroot,
                        batch_size=c["batch_size"],
                        n_threads=t.get("loader_threads", 4), seed=seed,
                        sigma=t["sigma"],
                        augmentation_ratio=t["augmentation_ratio"],
                        augmentation_method=t.get("augmentation_method",
                                                  "MM-Hand")),
        run=RunConfig(print_freq=t.get("print_freq", 100)),
        is_train=is_train)


_CONVS = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)


def weight_specs(nets: dict, conv_kind: str, conv_std) -> list:
    """The weight list of ``weights.draw`` for ``nets`` ({prefix: net}):
    each conv, conv-transpose or linear weight of kind ``conv_kind`` with
    standard deviation ``conv_std(module)``, each norm scale N(1, 0.02),
    every bias 0."""
    specs = []
    for prefix, net in nets.items():
        for mname, m in net.named_modules():
            for pname, p in m.named_parameters(recurse=False):
                name = f"{prefix}.{mname}.{pname}" if mname else \
                    f"{prefix}.{pname}"
                shape = tuple(p.shape)
                if pname == "bias":
                    specs.append((name, shape, "zero", 0.0))
                elif isinstance(m, _CONVS):
                    specs.append((name, shape, conv_kind, conv_std(m)))
                elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                    specs.append((name, shape, "scale", 0.02))
                else:
                    raise ValueError(f"no draw for {name}")
    return specs


def fan_in(m: nn.Module) -> int:
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


def pack_mask(kept: torch.Tensor):
    """A boolean mask as bits on the host, and a function that unpacks it
    to float32 of its shape on a device."""
    shape = kept.shape
    flat = kept.reshape(-1)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    bits = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], device=flat.device,
                        dtype=torch.uint8)
    packed = (flat.view(-1, 8).to(torch.uint8) * bits).sum(1, dtype=torch.uint8)
    packed = packed.cpu()
    n = math.prod(shape)

    def unpack(device="cpu") -> torch.Tensor:
        p = packed.to(device)
        b = bits.to(device)
        out = (p[:, None] & b) != 0
        return out.reshape(-1)[:n].reshape(shape).float()

    return unpack


def record_dropout_masks(nets: dict, masks: dict):
    """Forward hooks on every nn.Dropout of ``nets`` ({prefix: net}) that
    append the kept positions of each call (output != 0) to
    ``masks[<prefix>.<module name>]``; returns the hook handles."""
    handles = []
    for prefix, net in nets.items():
        for name, m in net.named_modules():
            if isinstance(m, nn.Dropout):
                key = f"{prefix}.{name}"

                def hook(module, args, out, key=key):
                    masks.setdefault(key, []).append(pack_mask(out != 0))

                handles.append(m.register_forward_hook(hook))
    return handles


def first_grads(parts, beta1: float) -> dict:
    """Each leaf's first gradient from Adam's first moment after one step,
    m = (1 - beta1) g, for ``parts`` [(prefix, net, optimizer)]; a leaf for
    which Adam holds no moment reads 0."""
    out = {}
    for prefix, net, opt in parts:
        for name, p in net.named_parameters():
            m = opt.state.get(p, {}).get("exp_avg")
            out[f"{prefix}.{name}"] = (0.0 if m is None
                                       else float(m.norm()) / (1 - beta1))
    return out


def change_norms(nets: dict, start: dict) -> dict:
    """Each leaf's distance from ``start`` ({<prefix>.<name>: tensor})."""
    with torch.no_grad():
        return {f"{k}.{n}": float((p - start[f"{k}.{n}"]).norm())
                for k, net in nets.items() for n, p in net.named_parameters()}


def free_cuda() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
