#!/usr/bin/env python
"""Export a train state that mmhand_tpu saved to the PyTorch port's format,
so that a run trained under mmhand_tpu resumes (or is scored) in
mmhand_torch.

mmhand_tpu saves one orbax checkpoint of the whole train state per label
(``<checkpoints_dir>/<name>/state_<label>/``, mmhand_tpu/utils/checkpoint.py).
This tool restores it with mmhand_tpu's own ``CheckpointManager`` into the
template that the run's own flags give (``init_state`` under the run's
config, the pools stacked per replica for a run on ``--world`` devices, as
mmhand_tpu/train/loop.py builds it), maps it with
``mmhand_torch.convert`` and writes ``state_<label>.pt`` beside the orbax
directory, where the port's trainer looks for it:

    python tools/export_jax_state.py --kind gan <scripts/train.py flags> \\
        [--world N]
    python -m mmhand_torch.scripts.train <the same flags> --continue_train

    python tools/export_jax_state.py --kind hpe <scripts/train_hpe.py flags>
    python tools/export_jax_state.py --kind hand3d --net lifting \\
        --name h3d --checkpoints_dir ck [--image_size 256 --crop_size 256]

``--kind gan`` reads ``<checkpoints_dir>/<name>/state_<which_epoch>`` (a run
of scripts/train.py), ``--kind hpe`` the same of scripts/train_hpe.py
(``--model`` picks the variant), ``--kind hand3d`` the ``latest`` state of
``<checkpoints_dir>/<name>_<net>`` (scripts/train_hand3d.py).  The command
line has no precision flags, as mmhand_tpu's has none: a GAN state that a
program saved through ``train()`` under its own ``Config`` (another
``PrecisionConfig``, say) is exported by calling ``export_gan(cfg)`` with
that Config.

The Adam moments, the step, the pools and the loss scales carry over; the
random streams cannot (torch draws other numbers), so the file is marked
``"rng": "fresh"`` and the port seeds them from the run's --seed when it
loads it.  Prints one JSON line: the kind, the label, the step, the world,
``"rng": "fresh"`` and the file written.

The tool imports JAX, orbax and mmhand_tpu (an orbax checkpoint cannot be
read without them); the port itself never does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

KINDS = ("gan", "hpe", "hand3d")


def port_config(cfg):
    """The mmhand_torch Config with the fields of mmhand_tpu's ``cfg`` (the
    two packages' configs have the same fields)."""
    from mmhand_torch import config as tcfg

    sections = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            value = type(getattr(tcfg.Config(), f.name))(
                **dataclasses.asdict(value))
        sections[f.name] = value
    return tcfg.Config(**sections)


def _zeros_like_shapes(fn, *args):
    """The tree ``fn(*args)`` returns, its leaves numpy zeros: the shapes of
    an init without computing it (a restore template)."""
    import jax
    import numpy as np

    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        jax.eval_shape(fn, *args))


def gan_template(cfg, world: int = 1):
    """mmhand_tpu's MMHandTrainState under ``cfg``; for a run on ``world``
    devices the pools stacked per replica (mmhand_tpu/train/loop.py:99-103,
    ``replicate_state_for_mesh``)."""
    import jax
    import numpy as np

    from mmhand_tpu.train.state import MMHandSystem

    system = MMHandSystem(cfg, axis_name="data" if world > 1 else None)
    state = _zeros_like_shapes(
        lambda k: system.init_state(k, local_batch_size=1),
        jax.random.PRNGKey(cfg.data.seed))
    if world > 1:
        stack = lambda x: np.zeros((world, *x.shape), x.dtype)  # noqa: E731
        state = state.replace(pool_pb=jax.tree.map(stack, state.pool_pb),
                              pool_pp=jax.tree.map(stack, state.pool_pp))
    return state


def hpe_template(cfg, variant: str):
    """mmhand_tpu's HPETrainState of ``variant`` under ``cfg``
    (scripts/train_hpe.py)."""
    import jax

    from mmhand_tpu.hpe import HPESystem

    system = HPESystem(lr=cfg.optim.lr, beta1=cfg.optim.beta1,
                       variant=variant)
    return _zeros_like_shapes(
        lambda k: system.init_state(k, size=cfg.model.fine_size),
        jax.random.PRNGKey(cfg.data.seed))


def hand3d_template(net: str, variant: str, image_size: int, crop_size: int,
                    seed: int):
    """mmhand_tpu's SubnetTrainState of ``net`` (scripts/train_hand3d.py)."""
    import jax

    from mmhand_tpu.hand3d import Hand3DSystem

    system = Hand3DSystem(net=net, variant=variant, crop_size=crop_size)
    return _zeros_like_shapes(
        lambda k: system.init_state(k, (image_size, image_size)),
        jax.random.PRNGKey(seed))


def _write(state: dict, checkpoints_dir: str, name: str, label: str) -> str:
    """``state`` as the port's ``state_<label>.pt`` of the run ``name``,
    written whole (a temporary file, then a rename)."""
    import torch

    from mmhand_torch.utils.checkpoint import CheckpointManager

    path = CheckpointManager(checkpoints_dir, name).path(label)
    torch.save(state, f"{path}.tmp")
    os.replace(f"{path}.tmp", path)
    return path


def _restore(template, checkpoints_dir: str, name: str, label: str):
    from mmhand_tpu.utils.checkpoint import CheckpointManager

    return CheckpointManager(checkpoints_dir, name).restore(template, label)


def _summary(kind: str, label: str, state: dict, path: str) -> dict:
    return {"kind": kind, "label": label, "step": state["step"],
            "world": state["world"], "rng": state["rng"], "path": path}


def export_gan(cfg, world: int = 1, label: str = None) -> dict:
    """The GAN state of the run ``cfg`` (mmhand_tpu's Config) labeled
    ``label`` (``cfg.run.which_epoch`` when None) -> ``state_<label>.pt``;
    returns the summary."""
    from mmhand_torch.convert import train_state_from_jax

    run = cfg.run
    label = label or run.which_epoch
    tree = _restore(gan_template(cfg, world), run.checkpoints_dir, run.name,
                    label)
    state = train_state_from_jax(tree, port_config(cfg), world)
    return _summary("gan", label, state,
                    _write(state, run.checkpoints_dir, run.name, label))


def export_hpe(cfg, variant: str = "hpm", world: int = 1,
               label: str = None) -> dict:
    """The HPE state of the run ``cfg`` (``--model variant``) ->
    ``state_<label>.pt``; returns the summary."""
    from mmhand_torch.convert import hpe_train_state_from_jax

    run = cfg.run
    label = label or run.which_epoch
    tree = _restore(hpe_template(cfg, variant), run.checkpoints_dir,
                    run.name, label)
    state = hpe_train_state_from_jax(tree, variant, world, port_config(cfg))
    return _summary("hpe", label, state,
                    _write(state, run.checkpoints_dir, run.name, label))


def export_hand3d(checkpoints_dir: str, name: str, net: str,
                  variant: str = "proposed", image_size: int = 256,
                  crop_size: int = 256, seed: int = 0) -> dict:
    """The ``latest`` state of ``<name>_<net>`` -> its
    ``state_latest.pt``; returns the summary."""
    from mmhand_torch.convert import hand3d_train_state_from_jax

    run = f"{name}_{net}"
    tree = _restore(hand3d_template(net, variant, image_size, crop_size,
                                    seed), checkpoints_dir, run, "latest")
    state = hand3d_train_state_from_jax(tree, net, variant)
    return _summary("hand3d", "latest", state,
                    _write(state, checkpoints_dir, run, "latest"))


def parse(argv=None) -> argparse.Namespace:
    from mmhand_tpu.config import add_cli_args

    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--kind", choices=KINDS, required=True)
    p.add_argument("--world", type=int, default=1,
                   help="devices (replicas) the run trained on")
    # scripts/train.py and scripts/train_hpe.py
    add_cli_args(p)
    p.add_argument("--model", default="hpm", choices=("hpm", "hpm2d", "hpm3d"))
    for flag in ("--max_steps", "--epochs"):  # accepted, not read
        p.add_argument(flag, type=int, default=None)
    p.add_argument("--vgg_npz", default=None)
    p.add_argument("--from_bin", default=None)
    # scripts/train_hand3d.py (--name, --checkpoints_dir and --seed above)
    p.add_argument("--net", choices=("handsegnet", "posenet", "lifting"))
    p.add_argument("--variant", default="proposed")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--bin", default=None)
    for flag in ("--batch_size", "--max_iter"):
        p.add_argument(flag, type=int, default=None)
    return p.parse_args(argv)


def export(argv=None) -> dict:
    """Parse ``argv`` and export; returns the summary."""
    from mmhand_tpu.config import Config, from_cli_args

    args = parse(argv)
    if args.kind == "hand3d":
        if args.net is None:
            raise SystemExit("--kind hand3d needs --net")
        return export_hand3d(args.checkpoints_dir or "./checkpoints",
                             args.name or "hand3d", args.net, args.variant,
                             args.image_size, args.crop_size, args.seed or 0)
    cfg = from_cli_args(args, Config())
    if args.kind == "gan":
        return export_gan(cfg, args.world)
    return export_hpe(cfg, args.model, args.world)


def main(argv=None) -> dict:
    from mmhand_tpu.utils.runtime import setup_runtime

    # the PRNG the training scripts use, so the template's keys match
    setup_runtime(compile_cache=False)
    summary = export(argv)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
