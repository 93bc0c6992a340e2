"""Network checkpoints in the reference's own naming:
``<checkpoints_dir>/<name>/<which_epoch>_net_<net>.pth`` holding a state_dict,
with ``net`` one of netG, netD_PB, netD_PP (reference base_model.py
save_network; README "Quick start" step 3)."""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn


def network_path(checkpoints_dir: str, name: str, which_epoch: str = "latest",
                 net: str = "netG") -> str:
    return os.path.join(checkpoints_dir, name, f"{which_epoch}_net_{net}.pth")


def save_network(module: nn.Module, checkpoints_dir: str, name: str,
                 which_epoch: str = "latest", net: str = "netG") -> str:
    path = network_path(checkpoints_dir, name, which_epoch, net)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()},
               path)
    return path


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A network state_dict from a ``.pth`` (or its ``.npz`` dump), with the
    reference's DataParallel ``module.`` and wrapper ``model.`` prefixes
    removed."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: torch.from_numpy(z[k]) for k in z.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if all(k.startswith("model.") for k in sd):
        sd = {k.removeprefix("model."): v for k, v in sd.items()}
    return sd
