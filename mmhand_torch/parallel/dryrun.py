"""Multi-process dry run of the data-parallel train steps on the CPU
(counterpart of ``dryrun_multichip`` in __graft_entry__.py).

``launch(argv, world)`` runs ``python argv...`` as ranks 0..world-1 with
the environment torchrun would give them (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR=localhost, MASTER_PORT a free port), so that each joins the
group through ``init_distributed``.  ``dryrun_multichip(n)`` launches this
module in ``n`` gloo processes, which run three DP train steps, 2 items per
rank: the GAN (32 px, ngf/ndf 8, 2 blocks, pool 4), the HPE trainer
(``hpm``, both CPM nets at full width, 32 px) and the hand3d lifting net
(``proposed``, crop 32).  Every metric must be finite.

    python -c "from mmhand_torch.parallel.dryrun import dryrun_multichip; \\
        print(dryrun_multichip(2))"
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv: list[str], world: int, timeout: float = 120,
           env: Optional[dict] = None) -> list[str]:
    """Run ``python argv...`` as ``world`` ranks; returns each rank's output
    (stdout and stderr).  Raises if a rank fails or the ranks outlive
    ``timeout`` seconds; every rank is killed before it returns."""
    port = str(free_port())
    with tempfile.TemporaryDirectory(prefix="mmhand_launch_") as tmp:
        logs = [open(Path(tmp) / f"rank{r}.log", "w+") for r in range(world)]
        procs = []
        try:
            for r in range(world):
                rank_env = {**os.environ, **(env or {}), "RANK": str(r),
                            "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
                            "MASTER_ADDR": "localhost", "MASTER_PORT": port}
                procs.append(subprocess.Popen(
                    [sys.executable, *argv], env=rank_env, stdout=logs[r],
                    stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = [p for p in procs if p.returncode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outputs = []
            for log in logs:
                log.seek(0)
                outputs.append(log.read())
                log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(
            f"ranks {bad} of {world} failed or were killed after {timeout} s "
            f"(exit codes {[procs[r].returncode for r in bad]}); rank "
            f"{bad[0]}'s output:\n{outputs[bad[0]][-4000:]}")
    return outputs


def toy_config():
    from mmhand_torch.config import Config, DataConfig, ModelConfig, OptimConfig

    return Config(model=ModelConfig(fine_size=32, g_n_blocks=2, n_layers_d=2,
                                    ngf=8, ndf=8),
                  optim=OptimConfig(pool_size=4),
                  data=DataConfig(dataset="synthetic"))


def toy_batch(global_batch: int, seed: int = 0) -> dict:
    """A global batch of uniform NHWC inputs, float32."""
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(-1, 1, (global_batch, 32, 32, c)).astype(np.float32)
            for k, c in [("H1", 3), ("H2", 3), ("D1", 3), ("D2", 3),
                         ("P1", 21), ("P2", 21)]}


def hpe_batch(global_batch: int, seed: int = 2) -> dict:
    """A global batch of the HPE step's inputs: uniform image, heatmaps and
    z, weight 1 (__graft_entry__.py:88-106)."""
    rng = np.random.RandomState(seed)
    f32 = lambda *shape: rng.uniform(0, 1, shape).astype(np.float32)  # noqa: E731
    return {"image": 2 * f32(global_batch, 32, 32, 3) - 1,
            "heatmaps": f32(global_batch, 32, 32, 21),
            "z": f32(global_batch, 21),
            "weight": np.ones(global_batch, np.int32)}


def hand3d_batch(global_batch: int, seed: int = 3) -> dict:
    """A global batch of the lifting step's inputs: uniform scoremaps, the
    left hand, normal canonical keypoints and identity rotations
    (__graft_entry__.py:108-131)."""
    rng = np.random.RandomState(seed)
    n = global_batch
    return {"scoremap": rng.uniform(0, 1, (n, 32, 32, 21)).astype(np.float32),
            "hand_side": np.tile(np.float32([[1, 0]]), (n, 1)),
            "keypoint_xyz21_can": rng.normal(size=(n, 21, 3)).astype(
                np.float32),
            "rot_mat": np.tile(np.eye(3, dtype=np.float32)[None], (n, 1, 1))}


def rank_slice(batch: dict, rank: int) -> dict:
    """Rank ``rank``'s 2 items of a global numpy batch, as tensors."""
    import torch

    return {k: torch.from_numpy(v[2 * rank:2 * rank + 2])
            for k, v in batch.items()}


def params_agree(a: dict, b: dict, updates: int,
                 lr: float) -> tuple[bool, str]:
    """Whether two state_dicts of one network after ``updates`` Adam updates
    each agree: at most 0.5% of its elements outside 2e-5 + 1e-3 |w|
    (running statistics 1e-5 + 1e-3 |w|), none more than 2 lr an update
    apart.  Adam divides each gradient by its own magnitude, so an element
    whose gradient is near zero takes an update that f32 rounding decides.
    Returns (agree, a summary)."""
    outside = total = 0
    worst = 0.0
    for k, v in b.items():
        if k.endswith("num_batches_tracked"):
            continue
        v = v.detach().cpu().float()
        diff = (a[k].detach().cpu().float() - v).abs()
        atol = 1e-5 if "running" in k else 2e-5
        outside += int((diff > atol + 1e-3 * v.abs()).sum())
        total += v.numel()
        worst = max(worst, float(diff.max()))
    return (outside <= 0.005 * total and worst <= 2 * lr * updates,
            f"{outside}/{total} outside, max {worst:.3g}")


def dryrun_multichip(n: int, timeout: float = 180) -> dict:
    """The three toy DP train steps in ``n`` gloo processes on the CPU;
    returns rank 0's metrics, averaged over the ranks, under "gan", "hpe"
    and "hand3d"."""
    with tempfile.TemporaryDirectory(prefix="mmhand_dryrun_") as tmp:
        out = Path(tmp) / "metrics.json"
        root = str(Path(__file__).resolve().parents[2])
        path = os.pathsep.join(filter(None, [root,
                                             os.environ.get("PYTHONPATH")]))
        launch(["-m", "mmhand_torch.parallel.dryrun", str(out)], n, timeout,
               env={"OMP_NUM_THREADS": "1", "PYTHONPATH": path})
        return json.loads(out.read_text())


def _finite(rank: int, leg: str, metrics: dict) -> dict:
    import math

    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"rank {rank}, {leg}: metrics {metrics}")
    return metrics


def _worker(out: str) -> None:
    import warnings

    import torch.distributed as dist

    from mmhand_torch.config import Config, ModelConfig
    from mmhand_torch.hand3d import Hand3DSystem, make_hand3d_train_step
    from mmhand_torch.hpe import HPESystem, make_hpe_train_step
    from mmhand_torch.parallel.mesh import init_distributed
    from mmhand_torch.train.state import build_system
    from mmhand_torch.train.step import make_train_step

    device = init_distributed("cpu")
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the random-VGG warning
            system = build_system(toy_config(), device, distributed=True)
        metrics = {"gan": _finite(rank, "gan", make_train_step(system)(
            rank_slice(toy_batch(2 * world), rank), 2e-4))}
        del system
        hpe = HPESystem(Config(model=ModelConfig(fine_size=32)), "hpm",
                        device, distributed=True)
        metrics["hpe"] = _finite(rank, "hpe", make_hpe_train_step(hpe)(
            rank_slice(hpe_batch(2 * world), rank), 2e-4))
        del hpe
        lift = Hand3DSystem("lifting", "proposed", crop_size=32,
                            device=device, seed=3, distributed=True)
        metrics["hand3d"] = _finite(rank, "hand3d", {
            "loss": make_hand3d_train_step(lift)(
                rank_slice(hand3d_batch(2 * world), rank))})
        if rank == 0:
            Path(out).write_text(json.dumps(metrics))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1])
