"""The augmentation-ratio study driver with the PyTorch port (counterpart
of scripts/mm_train_ratio.py; reference scripts/mm-train-ratio.sh:3-59).

For each ratio r in the sweep:
  1. train the GAN on the last r share of the train set
     (``mmhand_torch.scripts.train``);
  2. generate fakes for the unseen (1-r) complement
     (``mmhand_torch.scripts.aug``) into the '{method}_{dataroot-leaf}'
     sibling directory that ``HPEMixDataset`` reads;
  3. train the HPE on the real/synthetic mixture
     (``mmhand_torch.scripts.train_hpe``);
  4. evaluate EPE and PCK-AUC on the test set
     (``mmhand_torch.scripts.test_hpe``);
  5. with ``--with_hand3d``, below ratio 1.0, the second judge: pack the
     generated images into a hand3d GAN DB
     (``mmhand_torch.scripts.create_hand3d_db``), fine-tune ColorHandPose3D's
     posenet on it for --hand3d_iters iterations
     (``mmhand_torch.scripts.train_hand3d``) and score it
     (``mmhand_torch.scripts.eval_hand3d --mode 2d``).

    python -m mmhand_torch.scripts.mm_train_ratio --dataset RHD \\
        --dataroot /data/rhd_crop --test_dataroot /data/rhd_crop_test \\
        --ratios 1.0 0.8 0.6 0.4 0.2 --niter 500

Every stage runs as ``python -m`` in its own process on ``--device``
(default cuda) and must exit 0.  ``--extra_gan_args`` reach both GAN stages
(mmhand_tpu's driver gives them to ``train`` alone, so a model flag there
builds an ``aug`` generator that the checkpoint does not fit);
``--extra_hpe_args`` reach both HPE stages.  Each of the two takes every
argument after it, flags included, up to the other one or the end of the
command line (argparse's ``nargs`` takes no value that starts with --, so
mmhand_tpu's driver cannot pass a flag there at all):

    python -m mmhand_torch.scripts.mm_train_ratio ... \
        --extra_gan_args --fineSize 128 --ngf 32 --extra_hpe_args --fineSize 128

The hand3d stages take the GAN's --fineSize from --extra_gan_args (256
by default), the side of the images aug writes, as their image and crop
size.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from mmhand_torch.config import Config
from mmhand_torch.hpe.data import augmentation_dir_for

ROOT = Path(__file__).resolve().parents[2]
EXTRAS = ("--extra_gan_args", "--extra_hpe_args")


def split_extras(argv: list) -> tuple[list, dict]:
    """(the rest of ``argv``, {flag: its arguments}) for each flag of
    EXTRAS: a flag takes every argument after it up to the other flag or
    the end."""
    rest, extras, current = [], {flag: [] for flag in EXTRAS}, None
    for arg in argv:
        if arg in EXTRAS:
            current = arg
        elif current is None:
            rest.append(arg)
        else:
            extras[current].append(arg)
    return rest, extras


def fine_size(gan_extra: list) -> int:
    """The GAN's --fineSize among ``gan_extra``, else Config()'s."""
    size = argparse.ArgumentParser(add_help=False)
    size.add_argument("--fineSize", type=int,
                      default=Config().model.fine_size)
    return size.parse_known_args(gan_extra)[0].fineSize


def run(stage: str, args: list) -> None:
    cmd = [sys.executable, "-m", f"mmhand_torch.scripts.{stage}", *args]
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=str(ROOT))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--dataroot", required=True)
    parser.add_argument("--test_dataroot", required=True)
    parser.add_argument("--ratios", type=float, nargs="+",
                        default=[1.0, 0.8, 0.6, 0.4, 0.2])
    parser.add_argument("--method", default="MM-Hand")
    parser.add_argument("--batchSize", type=int, default=32)
    parser.add_argument("--niter", type=int, default=500)
    parser.add_argument("--hpe_epochs", type=int, default=90)
    parser.add_argument("--checkpoints_dir", default="./checkpoints")
    parser.add_argument("--device", default="cuda",
                        help="torch device of every stage")
    parser.add_argument("--with_hand3d", action="store_true",
                        help="also fine-tune and evaluate the hand3d "
                             "posenet on the generated data through the "
                             "packed binary GAN DB (the reference's second "
                             "judge: hand3d training_posenet.py on "
                             "BinaryDbReader_gan)")
    parser.add_argument("--hand3d_iters", type=int, default=30000)
    # --extra_gan_args and --extra_hpe_args (the module's docstring) are
    # taken out before argparse sees the rest
    rest, extras = split_extras(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(rest)
    gan_extra, hpe_extra = (extras[flag] for flag in EXTRAS)
    if args.with_hand3d and args.hand3d_iters < 1:
        raise ValueError(f"--hand3d_iters must be at least 1, got "
                         f"{args.hand3d_iters}")
    size = str(fine_size(gan_extra))

    ds, device = args.dataset, ["--device", args.device]
    for ratio in args.ratios:
        tag = f"{ds.lower()}_r{ratio:g}".replace(".", "p")
        gan_name = f"gan_{tag}"
        hpe_name = f"hpe_{tag}_{args.method}"

        # 1. GAN on the r share
        run("train", ["--dataset", ds, "--dataroot", args.dataroot,
                      "--name", gan_name, "--batchSize", str(args.batchSize),
                      "--augmentation_ratio", str(ratio),
                      "--niter", str(args.niter),
                      "--checkpoints_dir", args.checkpoints_dir,
                      *device, *gan_extra])

        # 2. generate the (1-r) complement into {method}_{leaf}
        if ratio < 1.0:
            run("aug", ["--dataset", ds, "--dataroot", args.dataroot,
                        "--name", gan_name,
                        "--augmentation_ratio", str(ratio),
                        "--checkpoints_dir", args.checkpoints_dir,
                        "--dst", augmentation_dir_for(args.dataroot,
                                                      args.method),
                        *device, *gan_extra])

        # 3. HPE on the mixture
        run("train_hpe", ["--dataset", ds, "--dataroot", args.dataroot,
                          "--name", hpe_name,
                          "--batchSize", str(args.batchSize),
                          "--augmentation_ratio", str(ratio),
                          "--augmentation_method", args.method,
                          "--epochs", str(args.hpe_epochs),
                          "--checkpoints_dir", args.checkpoints_dir,
                          *device, *hpe_extra])

        # 4. evaluate
        run("test_hpe", ["--dataset", ds, "--dataroot", args.test_dataroot,
                         "--name", hpe_name,
                         "--checkpoints_dir", args.checkpoints_dir,
                         *device, *hpe_extra])

        # 5. the second judge: the hand3d posenet fine-tuned on the
        # generated images (reference hand3d training_posenet.py fed by
        # create_GAN_DB's output through BinaryDbReader_gan)
        if args.with_hand3d and ratio < 1.0:
            db = str(Path(args.checkpoints_dir) / f"gan_db_{tag}.bin")
            h3d = ["--bin", db, "--name", f"h3d_{tag}",
                   "--image_size", size, "--crop_size", size,
                   "--checkpoints_dir", args.checkpoints_dir, *device]
            run("create_hand3d_db", [
                "--dataroot", args.dataroot,
                "--images", augmentation_dir_for(args.dataroot, args.method),
                "--out", db])
            run("train_hand3d", ["--net", "posenet",
                                 "--max_iter", str(args.hand3d_iters), *h3d])
            run("eval_hand3d", ["--mode", "2d", *h3d])


if __name__ == "__main__":
    main()
