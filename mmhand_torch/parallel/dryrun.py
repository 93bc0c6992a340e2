"""Multi-process dry run of the data-parallel GAN step on the CPU
(counterpart of the GAN part of ``dryrun_multichip`` in __graft_entry__.py).

``launch(argv, world)`` runs ``python argv...`` as ranks 0..world-1 with
the environment torchrun would give them (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR=localhost, MASTER_PORT a free port), so that each joins the
group through ``init_distributed``.  ``dryrun_multichip(n)`` launches this
module in ``n`` gloo processes: one toy DP train step (32 px, ngf/ndf 8, 2
blocks, pool 4, batch 2 per rank), whose metrics must be finite.

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


def dryrun_multichip(n: int, timeout: float = 120) -> dict:
    """One toy DP train step in ``n`` gloo processes on the CPU; returns rank
    0's metrics, averaged over the ranks."""
    with tempfile.TemporaryDirectory(prefix="mmhand_dryrun_") as tmp:
        out = Path(tmp) / "metrics.json"
        root = str(Path(__file__).resolve().parents[2])
        path = os.pathsep.join(filter(None, [root,
                                             os.environ.get("PYTHONPATH")]))
        launch(["-m", "mmhand_torch.parallel.dryrun", str(out)], n, timeout,
               env={"OMP_NUM_THREADS": "1", "PYTHONPATH": path})
        return json.loads(out.read_text())


def _worker(out: str) -> None:
    import math
    import warnings

    import torch
    import torch.distributed as dist

    from mmhand_torch.parallel.mesh import init_distributed
    from mmhand_torch.train.state import build_system
    from mmhand_torch.train.step import make_train_step

    device = init_distributed("cpu")
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the random-VGG warning
            system = build_system(toy_config(), device, distributed=True)
        batch = {k: torch.from_numpy(v[2 * rank:2 * rank + 2])
                 for k, v in toy_batch(2 * world).items()}
        metrics = {k: float(v) for k, v in
                   make_train_step(system)(batch, 2e-4).items()}
        if not all(math.isfinite(v) for v in metrics.values()):
            raise RuntimeError(f"rank {rank}: metrics {metrics}")
        if rank == 0:
            Path(out).write_text(json.dumps(metrics))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1])
