"""Checkpoints of the GAN trainer (counterpart of
mmhand_tpu/utils/checkpoint.py).

* Network checkpoints in the reference's own naming:
  ``<checkpoints_dir>/<name>/<which_epoch>_net_<net>.pth`` holding a
  state_dict, with ``net`` one of netG, netD_PB, netD_PP (reference
  base_model.py save_network; README "Quick start" step 3), which aug,
  evaluate_gan and tools/convert_mmhand_torch.py read.
* ``CheckpointManager``: the whole train state of ``--continue_train``, one
  ``state_<label>.pt`` per label (``latest`` and the epoch numbers): the
  nets with their running statistics, the three Adams, the step, the loss
  scales, and each rank's pools and random streams, stacked over the ranks.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mmhand_torch.parallel.sharding import gather_ranks
from mmhand_torch.utils import trace


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


class CheckpointManager:
    """``state_<label>.pt`` files under ``<checkpoints_dir>/<name>``.

    ``save`` is called on every rank (each rank's pools and random streams
    are gathered into (world, ...) tensors) and only the master writes, to a
    temporary file that then replaces the old one, so a crash never leaves a
    torn checkpoint; every rank returns once the file is in place.  ``restore`` reads the file on every rank and keeps its
    own row of the per-rank tensors; a checkpoint of another world size
    raises, since its global batch and pools differ."""

    def __init__(self, checkpoints_dir: str, name: str):
        self.root = os.path.abspath(os.path.join(checkpoints_dir, name))
        os.makedirs(self.root, exist_ok=True)

    def path(self, label: str) -> str:
        return os.path.join(self.root, f"state_{label}.pt")

    def save(self, system, label: str = "latest") -> None:
        """The span ``ckpt.save`` (``utils.trace``): the step's stall."""
        with trace.span("ckpt.save"):
            self._save(system, label)

    def _save(self, system, label: str) -> None:
        state = system.state_dict()
        own = state.pop("rank")
        if system.distributed:
            ranks = {k: gather_ranks(v.to(system.device)).cpu()
                     for k, v in own.items()}
        else:
            ranks = {k: v.cpu()[None] for k, v in own.items()}
        if system.rank == 0:
            path = self.path(label)
            torch.save({**state, "rank": ranks, "world": system.world},
                       f"{path}.tmp")
            os.replace(f"{path}.tmp", path)
        if system.distributed:  # every rank returns with the file in place
            dist.barrier()

    def restore(self, system, label: str = "latest") -> bool:
        """Load ``state_<label>.pt`` into ``system``; True when the file holds
        no random streams (a state mmhand_tpu trained, ``"rng":
        "fresh"``), which the system then seeds from its seed."""
        path = self.path(label)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no checkpoint labeled '{label}' under {self.root}")
        state = torch.load(path, map_location=system.device, weights_only=True)
        if state["world"] != system.world:
            raise ValueError(
                f"{path} was saved by {state['world']} ranks, this run has "
                f"{system.world}: its global batch and per-rank pools differ")
        # copies: a generator's set_state misreads a view at an offset
        state["rank"] = {k: v[system.rank].clone()
                         for k, v in state["rank"].items()}
        system.load_state_dict(state)
        return state.get("rng") == "fresh"

    def has(self, label: str = "latest") -> bool:
        return os.path.exists(self.path(label))

    def available_labels(self) -> list:
        return sorted(f[len("state_"):-len(".pt")] for f in os.listdir(self.root)
                      if f.startswith("state_") and f.endswith(".pt"))
