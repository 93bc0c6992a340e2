"""GAN training with the PyTorch port (counterpart of scripts/train.py;
reference train.py:10-65).

The command line keeps the reference's flag names (``mmhand_torch/config.py``);
a data-free run:

    python -m mmhand_torch.scripts.train --dataset synthetic --batchSize 16 \\
        --fineSize 256 --max_steps 6

It trains on ``--device`` (default cuda) and never moves to another device on
its own.  Without ``--vgg_npz`` (tools/convert_torch_weights.py) the
perceptual term runs on random VGG19 weights, with a warning.

``--continue_train`` resumes from ``state_<--which_epoch>.pt`` when it
exists.  ``--multihost`` trains data-parallel, one process per device, as
launched by torchrun: NCCL on ``cuda:LOCAL_RANK``, or gloo with
``--device cpu``; --batchSize is the global batch.

    python -m torch.distributed.run --nproc_per_node 4 \\
        -m mmhand_torch.scripts.train --multihost --dataset synthetic ...

``--profile`` writes a torch.profiler trace of the first steps (3 unless
--max_steps says otherwise) to ``<checkpoints_dir>/<name>/trace``, and
beside it the program's spans and counters (``program.json``).  Float16
with loss scaling is ``PrecisionConfig(compute_dtype="float16",
loss_scaling=True)`` through ``train()``; the command line has no flag for
either, as mmhand_tpu's has none.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os

import torch.distributed as dist

from mmhand_torch.config import Config, add_cli_args, from_cli_args
from mmhand_torch.parallel import init_distributed
from mmhand_torch.train.loop import TrainResult, train
from mmhand_torch.utils import trace
from mmhand_torch.utils.logging import profile_trace


def main(argv=None) -> TrainResult:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_cli_args(parser)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N optimizer steps (smoke runs)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override total epochs (default niter+niter_decay)")
    parser.add_argument("--vgg_npz", type=str, default=None,
                        help="converted VGG19 weights "
                             "(tools/convert_torch_weights.py)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on")
    parser.add_argument("--n_blocks", type=int, default=None,
                        help="the generator's PATBlocks (9 by default; "
                             "mmhand_tpu's command line has no such flag)")
    parser.add_argument("--profile", action="store_true",
                        help="torch.profiler trace of the first steps under "
                             "checkpoints/<name>/trace")
    parser.add_argument("--multihost", action="store_true",
                        help="one rank of a torchrun launch: data-parallel "
                             "over torch.distributed")
    args = parser.parse_args(argv)

    cfg = from_cli_args(args, Config())
    if args.n_blocks is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, g_n_blocks=args.n_blocks))
    device, master = args.device, True
    if args.multihost:
        device = init_distributed(args.device)
        master = dist.get_rank() == 0
    max_steps = (args.max_steps or 3) if args.profile else args.max_steps
    trace_dir = os.path.join(cfg.run.checkpoints_dir, cfg.run.name, "trace")
    try:
        with (profile_trace(trace_dir) if args.profile and master
              else contextlib.nullcontext()):
            result = train(cfg, device=device, max_steps=max_steps,
                           vgg_npz=args.vgg_npz, total_epochs=args.epochs,
                           distributed=args.multihost)
    finally:
        if args.multihost:
            dist.destroy_process_group()
    if master:
        if args.profile:
            print(f"profile trace written to {trace_dir}")
        rate = ("" if result.images_per_sec is None else
                f"; {result.images_per_sec:.2f} images/s after the first step")
        print(f"done: {result.steps} steps{rate}, last metrics: "
              f"{ {k: round(v, 4) for k, v in result.last_metrics.items()} }")
        print(f"{LAUNCHES_LINE}{json.dumps(kernel_launches())}")
    return result


LAUNCHES_LINE = "kernel launches: "
# each kernel's launch counter in ``utils.trace``, by its wrapper's name
LAUNCH_COUNTERS = {"gaussian_heatmaps": "k1.launches",
                   "bn_sums": "k2.launches",
                   "bn_sums_backward": "k2b.launches",
                   "bn_apply": "bn_apply.launches",
                   "bn_apply_backward": "bn_apply_bwd.launches",
                   "reflect_pad": "reflect_pad.launches",
                   "reflect_pad_backward": "reflect_pad_bwd.launches",
                   "generate_jointsmap": "k3.launches"}


def kernel_launches(names=("gaussian_heatmaps", "bn_sums",
                           "bn_sums_backward", "bn_apply",
                           "bn_apply_backward", "reflect_pad",
                           "reflect_pad_backward")) -> dict:
    """The launches of the kernels of ``names`` (by default the train
    step's: K1, the heatmaps; K2 and K2b, the BatchNorm sums; the
    BatchNorm normalize and its backward; the reflect pad and its
    backward) since the counters were last reset; 0 on the CPU, where the
    plain versions run."""
    counted = trace.counters()
    return {k: counted.get(LAUNCH_COUNTERS[k], 0) for k in names}


if __name__ == "__main__":
    main()
