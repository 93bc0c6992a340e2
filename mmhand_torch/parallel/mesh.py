"""Joining the process group of data-parallel training (counterpart of
mmhand_tpu/parallel/mesh.py and of ``jax.distributed.initialize()`` in
scripts/train.py; reference options/base_options.py:171-178, NCCL env://
rendezvous).

The reference's only parallelism is data parallelism, and so is the port's:
one process per device, launched by ``torch.distributed.run`` (torchrun),
which sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device_type: str = "cuda") -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this process's device: ``cuda:LOCAL_RANK`` over NCCL, or the CPU
    over gloo."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"{', '.join(missing)} not set: launch with "
                           f"python -m torch.distributed.run")
    env = {k: os.environ[k] for k in _ENV}
    if device_type == "cuda":
        device = torch.device("cuda", int(env["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"init_distributed: no backend for {device_type}")
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]))
    return device
