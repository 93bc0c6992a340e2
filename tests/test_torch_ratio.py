"""The port's ratio-study driver end to end on the CPU at toy size:
``python -m mmhand_torch.scripts.mm_train_ratio`` over a crop tree the test
writes (PNGs, packed depth, annotation.pickle), at ratios 0.5 and 1.0.

Each stage is a process of its own.  The GAN stages run at 32 px, ngf and
ndf 8, one epoch (2 steps at ratio 0.5, 4 at 1.0; ``aug`` accepts no
--max_steps, so the cut is --niter 1 --niter_decay 0, which both GAN stages
parse); the HPE stages at 32 px on the first 4 items, one epoch of 2 steps
(``test_hpe`` accepts no --max_steps either, so the cut is
--max_dataset_size 4 and --hpe_epochs 1), saving its 0.9 GB state once
(--save_epoch_freq 10).  ``aug`` must load the ngf-8
generator, so the run exits 0 only if --extra_gan_args reached it.  With
--with_hand3d, ratio 0.5 also packs the 4 generated images into a hand3d GAN
DB, trains posenet on it for 2 iterations at the GAN's 32 px and scores it
(eval_hand3d --mode 2d).
"""

import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from mmhand_torch.config import Config, DataConfig, ModelConfig
from mmhand_torch.data.rhd_tree import write_rhd_tree
from mmhand_torch.hpe.data import HPEMixDataset, augmentation_dir_for
from mmhand_torch.scripts import mm_train_ratio
from test_torch_threads import two_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SIZE, N_TRAIN, N_TEST = 32, 8, 4
RATIOS = (0.5, 1.0)


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    # every stage runs with 2 OpenMP threads: the suite runs several files
    # at once, and a pool of one thread per core then stalls for minutes
    root = tmp_path_factory.mktemp("ratio")
    train = write_rhd_tree(str(root / "rhd_train"), N_TRAIN, SIZE, seed=1)
    test = write_rhd_tree(str(root / "rhd_test"), N_TEST, SIZE, seed=2)
    argv = ["--dataset", "RHD", "--dataroot", train, "--test_dataroot", test,
            "--ratios", *map(str, RATIOS), "--batchSize", "2",
            "--niter", "1", "--hpe_epochs", "1", "--device", "cpu",
            "--checkpoints_dir", str(root / "ckpt"),
            "--with_hand3d", "--hand3d_iters", "2",
            "--extra_gan_args", "--fineSize", str(SIZE), "--ngf", "8",
            "--ndf", "8", "--niter_decay", "0",
            "--extra_hpe_args", "--fineSize", str(SIZE),
            "--max_dataset_size", "4", "--save_epoch_freq", "10"]
    proc = subprocess.run(
        [sys.executable, "-m", "mmhand_torch.scripts.mm_train_ratio", *argv],
        cwd=str(REPO), capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    yield train, proc.stdout
    # each HPE state file is ~0.9 GB
    shutil.rmtree(root / "ckpt", ignore_errors=True)


def _stages(out: str) -> list[tuple[str, list[str]]]:
    runs = re.findall(r"^\+ \S+ -m mmhand_torch\.scripts\.(\w+) (.*)$", out,
                      re.M)
    return [(stage, args.split()) for stage, args in runs]


def test_every_stage_ran_on_the_device_asked_for(study):
    """train, aug (ratio 0.5 only), train_hpe and test_hpe per ratio, and
    at ratio 0.5 the three hand3d stages, each with --device cpu but the DB
    writer; the GAN flags reach aug, the HPE flags both HPE stages, the
    GAN's --fineSize the hand3d stages."""
    stages = _stages(study[1])
    assert [s for s, _ in stages] == [
        "train", "aug", "train_hpe", "test_hpe", "create_hand3d_db",
        "train_hand3d", "eval_hand3d", "train", "train_hpe", "test_hpe"]
    for stage, args in stages:
        if stage == "create_hand3d_db":
            continue
        assert args[args.index("--device") + 1] == "cpu", stage
        if stage in ("train", "aug"):
            assert args[args.index("--ngf") + 1] == "8", stage
        elif stage in ("train_hand3d", "eval_hand3d"):
            assert args[args.index("--image_size") + 1] == str(SIZE), stage
        else:
            assert args[args.index("--max_dataset_size") + 1] == "4", stage
    assert study[1].count("done: 2 steps") == 3  # GAN at 0.5, both HPEs


def test_aug_wrote_exactly_the_marked_images(study):
    """{method}_{leaf} holds a fake for every image HPEMixDataset marks at
    ratio 0.5, and for no other."""
    train, _ = study
    aug_dir = Path(augmentation_dir_for(train, "MM-Hand")) / "color"
    written = sorted(p.name for p in aug_dir.glob("*.png"))
    cfg = Config(model=ModelConfig(fine_size=SIZE),
                 data=DataConfig(dataset="RHD", dataroot=train,
                                 augmentation_ratio=0.5))
    ds = HPEMixDataset(cfg)
    marked = sorted(os.path.basename(p) for p, m in
                    zip(ds.paths, ds.augmentation_map) if m)
    assert written == marked == [f"{i}.png" for i in range(N_TRAIN // 2)]


@pytest.mark.parametrize("ratio,reads", [(0.5, 4), (1.0, 0)])
def test_train_hpe_read_the_generated_images(study, ratio, reads):
    """Its first 4 items at ratio 0.5 are the 4 marked images: all come
    from the augmentation directory; at ratio 1.0 none does."""
    done = re.findall(r"^done: 2 steps, mse=\S+ lz=\S+; .*; (\d+) augmented "
                      r"images read$", study[1], re.M)
    assert len(done) == 2
    assert int(done[RATIOS.index(ratio)]) == reads


@pytest.mark.parametrize("ratio", RATIOS)
def test_test_hpe_printed_finite_scores(study, ratio):
    blocks = study[1].split("################# 2d #################")[1:]
    assert len(blocks) == 2
    scores = re.findall(r"^(epe_mean|epe_median|auc): (\S+)$",
                        blocks[RATIOS.index(ratio)], re.M)
    # the 2d block, then the 3d block
    assert [k for k, _ in scores] == ["epe_mean", "epe_median", "auc"] * 2
    assert all(math.isfinite(float(v)) for _, v in scores), scores
    assert all(0.0 <= float(v) <= 1.0 for k, v in scores if k == "auc")


def test_hand3d_judge_trained_on_the_generated_images(study):
    """The GAN DB holds the 4 generated images; posenet's loss on them is
    above 0 (their keypoints are visible: the repaired hand side); the 2d
    EPE and AUC are finite."""
    out = study[1]
    assert re.search(r"^wrote 4 records to \S+gan_db_rhd_r0p5\.bin", out,
                     re.M)
    losses = re.findall(r"^Training finished after 2 iterations; final loss "
                        r"(\S+)$", out, re.M)
    assert len(losses) == 1 and float(losses[0]) > 0
    scores = re.findall(r"^(Average mean EPE|Average median EPE|Area under "
                        r"curve): ([^ \n]+)", out, re.M)
    assert [k for k, _ in scores] == ["Average mean EPE",
                                      "Average median EPE", "Area under curve"]
    assert all(math.isfinite(float(v)) for _, v in scores), scores


def test_with_hand3d_raises(tmp_path):
    """--with_hand3d refuses a --hand3d_iters below 1 before any stage."""
    with pytest.raises(ValueError, match="hand3d_iters"):
        mm_train_ratio.main(["--dataset", "RHD", "--dataroot", str(tmp_path),
                             "--test_dataroot", str(tmp_path),
                             "--with_hand3d", "--hand3d_iters", "0"])


@pytest.mark.parametrize("argv,rest,gan,hpe", [
    (["--dataset", "RHD"], ["--dataset", "RHD"], [], []),
    (["--ratios", "1.0", "--extra_gan_args", "--ngf", "8", "--extra_hpe_args",
      "--fineSize", "32"], ["--ratios", "1.0"], ["--ngf", "8"],
     ["--fineSize", "32"]),
    (["--extra_hpe_args", "--max_dataset_size", "4", "--extra_gan_args",
      "--niter_decay", "0", "--dataset", "RHD"], [],
     ["--niter_decay", "0", "--dataset", "RHD"], ["--max_dataset_size", "4"]),
])
def test_extras_take_flags(argv, rest, gan, hpe):
    got_rest, extras = mm_train_ratio.split_extras(argv)
    assert got_rest == rest
    assert extras == {"--extra_gan_args": gan, "--extra_hpe_args": hpe}
