"""The port's CSV chain against mmhand_tpu's: pose maps, the PATN-style pair
dataset and the baseline exports; and the chain from raw RHD frames to two
training steps.

mmhand_tpu's chain does not reach training: its ``keypoints`` export drops
the image's extension from the name, so its pose maps are
``color/00000.npy``, while its dataset reads the pair's name plus ``.npy``
(``color/00000.png.npy``).  The port keeps the extension on both sides, the
reference's PATN convention; ``test_jax_chain_stops_at_a_missing_pose_map``
pins mmhand_tpu's fault.
"""

import filecmp
import importlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mmhand_torch.data import build_dataset
from mmhand_torch.data import csv_dataset as tcsv
from mmhand_torch.data.loader import HostLoader, make_prepare_batch
from mmhand_torch.data.preprocess import create_rhd_db
from mmhand_torch.data.raw_sources import write_raw_rhd
from mmhand_torch.scripts import export_baseline_formats as texport
from mmhand_torch.scripts import generate_pose_maps as tgen
from mmhand_torch.scripts import train as ttrain
from mmhand_tpu.data import csv_dataset as jcsv
from mmhand_tpu.data import preprocess as jpre

REPO = Path(__file__).resolve().parent.parent
SIZE = 32
LOSS_KEYS = {"pair_L1loss", "pair_GANloss", "D_PB", "D_PP", "origin_L1",
             "perceptual"}


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads while this file runs: the suite runs several
    files at once."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jexport():
    """mmhand_tpu's scripts/export_baseline_formats.py as a module."""
    import sys

    sys.path.insert(0, str(REPO / "scripts"))
    try:
        return importlib.import_module("export_baseline_formats")
    finally:
        sys.path.remove(str(REPO / "scripts"))


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Raw RHD frames -> crops in img/train -> pairs.csv, keypoints.csv ->
    pose maps in pose/trainP, all by the port's CLIs."""
    root = tmp_path_factory.mktemp("chain")
    raw = write_raw_rhd(root / "raw", 12, seed=5)
    crops = root / "img" / "train"
    assert create_rhd_db(raw, str(crops), SIZE, workers=2) == 16
    pairs, keypoints = root / "pairs.csv", root / "keypoints.csv"
    assert texport.main(["pairs", str(crops), str(pairs)]) == 16
    assert texport.main(["keypoints", str(crops), str(keypoints)]) == 16
    assert tgen.main([str(keypoints), str(root / "pose" / "trainP"),
                      "--size", str(SIZE), str(SIZE)]) == 16
    return root


def test_cords_to_map_matches_jax():
    rng = np.random.RandomState(0)
    cords = rng.uniform(-5, 40, (21, 2))
    cords[[3, 7], 0] = tcsv.MISSING_VALUE
    cords[11, 1] = tcsv.MISSING_VALUE
    got = tcsv.cords_to_map(cords, (SIZE, 40), 6.0)
    np.testing.assert_array_equal(got, jcsv.cords_to_map(cords, (SIZE, 40), 6.0))
    assert got.shape == (SIZE, 40, 21) and got.dtype == np.float32
    assert not got[..., [3, 7, 11]].any() and got.min() >= 0
    assert tcsv.MISSING_VALUE == jcsv.MISSING_VALUE
    y, x = "[1.5, -1, 3]", "[2.25, 4, -1]"
    np.testing.assert_array_equal(tcsv.load_pose_cords_from_strings(y, x),
                                  jcsv.load_pose_cords_from_strings(y, x))


@pytest.mark.parametrize("sigma", [6.0, 3.5])
def test_compute_pose_maps_matches_jax(chain, tmp_path, sigma):
    """The same keypoint CSV renders the same maps in both packages (the
    port reads it with the csv module, mmhand_tpu with pandas)."""
    keypoints = str(chain / "keypoints.csv")
    n = tcsv.compute_pose_maps(keypoints, str(tmp_path / "port"), (SIZE, 24),
                               sigma)
    assert n == jcsv.compute_pose_maps(keypoints, str(tmp_path / "jax"),
                                       (SIZE, 24), sigma) == 16
    names = sorted(os.listdir(tmp_path / "port" / "color"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "color"))
    assert names[0] == "00000.png.npy"
    for name in names:
        got = np.load(tmp_path / "port" / "color" / name)
        np.testing.assert_array_equal(
            got, np.load(tmp_path / "jax" / "color" / name))
        assert got.shape == (SIZE, 24, 21)


def test_exports_match_jax_but_keep_the_extension(chain, tmp_path, jexport):
    crops = str(chain / "img" / "train")
    jexport.export_pairs(crops, str(tmp_path / "pairs.csv"))
    assert filecmp.cmp(chain / "pairs.csv", tmp_path / "pairs.csv",
                       shallow=False)
    jexport.export_keypoints(crops, str(tmp_path / "keypoints.csv"))
    got = tcsv.read_csv_rows(str(chain / "keypoints.csv"), ":")
    want = tcsv.read_csv_rows(str(tmp_path / "keypoints.csv"), ":")
    assert [r["name"] for r in got] == [r["name"] + ".png" for r in want]
    assert [(r["keypoints_y"], r["keypoints_x"]) for r in got] == [
        (r["keypoints_y"], r["keypoints_x"]) for r in want]
    pairs = tcsv.read_csv_rows(str(chain / "pairs.csv"))
    names = {r["name"] for r in got}
    assert all(r["from"] in names and r["to"] in names for r in pairs)


def test_pix2pixhd_labels_equal_jax(chain, tmp_path, jexport, capsys):
    """The labels, rasterized in batches of 4 by the port's jointsmap (its
    plain version on the CPU), equal mmhand_tpu's per-image XLA
    rasterization byte for byte, and so do the image copies."""
    crops = str(chain / "img" / "train")
    n = texport.main(["pix2pixhd", crops, str(tmp_path / "port"), "--size",
                      str(SIZE), "--device", "cpu", "--batch", "4"])
    assert "pix2pixhd: exported 16 entries" in capsys.readouterr().out
    assert n == jexport.export_pix2pixhd(crops, str(tmp_path / "jax"),
                                         size=SIZE) == 16
    for sub in ("train_label", "train_img"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub))
        assert len(names) == 16
        for name in names:
            assert filecmp.cmp(tmp_path / "port" / sub / name,
                               tmp_path / "jax" / sub / name, shallow=False)


@pytest.mark.parametrize("phase,use_flip", [("train", True), ("train", False),
                                            ("test", False)])
def test_dataset_items_match_jax(chain, phase, use_flip):
    """Given the same pose files, both datasets draw the same pairs and
    flips from the same seed and give the same arrays."""
    if phase == "test":
        os.symlink(chain / "img" / "train", chain / "img" / "test")
        os.symlink(chain / "pose" / "trainP", chain / "pose" / "testP")
    kw = dict(image_root=str(chain / "img"), pose_root=str(chain / "pose"),
              pair_lst=str(chain / "pairs.csv"), phase=phase,
              use_flip=use_flip, seed=11)
    port, jax_ds = tcsv.MMHandCSVDataset(**kw), jcsv.MMHandCSVDataset(**kw)
    assert len(port) == len(jax_ds) == 16
    flips = 0
    for i in range(8):
        got, want = port[i], jax_ds[i]
        assert list(got) == list(want)
        assert (got["H1_path"], got["H2_path"]) == (want["H1_path"],
                                                    want["H2_path"])
        for key in ("H1", "P1", "D1", "H2", "P2", "D2"):
            np.testing.assert_array_equal(got[key], want[key])
            assert got[key].dtype == np.float32
        assert got["P1"].shape == (SIZE, SIZE, 21)
        assert got["D1"].shape == got["H1"].shape == (SIZE, SIZE, 3)
        raw_h1 = np.asarray(Image.open(
            chain / "img" / "train" / got["H1_path"]), np.float32)
        flips += not np.array_equal(got["H1"], (raw_h1 / 255.0 - 0.5) / 0.5)
    assert (flips > 0) == use_flip


def test_depth_path_swaps_only_the_image_component(tmp_path):
    """Every ``color`` of the relative name becomes ``depth``, as in
    mmhand_tpu (STB's SK_color_3.png -> SK_depth_3.png); a ``color`` in the
    image root stays, where mmhand_tpu's replace would send the depth read
    to a folder that does not exist.  A name with no ``color`` raises."""
    root = str(tmp_path / "color_runs" / "train")
    assert tcsv.depth_path(root, "color/00003.png") == os.path.join(
        root, "depth", "00003.png")
    stb = "B1Counting/SK_color_3.png"
    assert tcsv.depth_path(root, stb) == os.path.join(
        root, "B1Counting", "SK_depth_3.png")
    jax_ds = object.__new__(jcsv.MMHandCSVDataset)
    jax_ds.dir_h, jax_ds.dir_p = str(tmp_path / "train"), str(tmp_path / "P")
    assert jax_ds._paths(stb)[2] == tcsv.depth_path(str(tmp_path / "train"),
                                                    stb)
    assert os.path.join(root, "color/00003.png").replace(
        "color", "depth") != tcsv.depth_path(root, "color/00003.png")
    with pytest.raises(ValueError, match="no color image"):
        tcsv.depth_path(root, "B1Counting/SK_3.png")


def test_dataset_under_a_root_named_color(chain, tmp_path):
    os.symlink(chain / "img", tmp_path / "color_img")
    ds = tcsv.MMHandCSVDataset(str(tmp_path / "color_img"),
                               str(chain / "pose"), str(chain / "pairs.csv"),
                               seed=1)
    item = ds[0]
    assert np.isfinite(item["D2"]).all() and item["D2"].shape == (SIZE, SIZE, 3)
    jax_ds = jcsv.MMHandCSVDataset(str(tmp_path / "color_img"),
                                   str(chain / "pose"), str(chain / "pairs.csv"),
                                   seed=1)
    with pytest.raises(FileNotFoundError):
        jax_ds[0]


def _csv_config(chain, **data):
    from mmhand_torch.config import Config, DataConfig, ModelConfig

    return Config(model=ModelConfig(fine_size=SIZE),
                  data=DataConfig(dataset="MMHand",
                                  pair_lst=str(chain / "pairs.csv"),
                                  image_root=str(chain / "img"),
                                  pose_root=str(chain / "pose"), **data))


def _epoch_draws(loader, epoch):
    """Each item's pair and a flip-sensitive sum of its H1, in the loader's
    order."""
    return [(s, t, float(h[:, :4].sum()))
            for raw in loader.epoch(epoch)
            for s, t, h in zip(raw["src_paths"], raw["tgt_paths"], raw["H1"])]


def test_build_dataset_and_loader_pass_prerendered_batches(chain):
    from mmhand_torch.config import DataConfig

    cfg = _csv_config(chain, seed=2)
    ds = build_dataset(cfg)
    assert isinstance(ds, tcsv.MMHandCSVDataset) and ds.prerendered
    raw = next(HostLoader(ds, 3, seed=2, num_threads=2).epoch(0))
    assert len(raw["src_paths"]) == 3
    batch = make_prepare_batch(6.0, "cpu")(
        {k: v for k, v in raw.items() if not k.endswith("paths")})
    assert sorted(batch) == ["D1", "D2", "H1", "H2", "P1", "P2"]
    for k, v in batch.items():
        np.testing.assert_array_equal(v.numpy(), raw[k])
    with pytest.raises(ValueError, match="--pairLst"):
        build_dataset(cfg.replace(data=DataConfig(dataset="MMHand")))


def test_loader_draws_depend_on_seed_epoch_and_index_only(chain):
    """The train-mode draws of an epoch do not depend on the loader's
    threads or on the epochs read before (so a resumed run draws what the
    first drew), and two epochs draw differently."""
    from mmhand_torch.train.loop import make_loader

    kw = dict(seed=3, batch_size=4, use_flip=True)
    serial = make_loader(_csv_config(chain, n_threads=1, **kw))
    first = [_epoch_draws(serial, e) for e in (1, 2)]
    resumed = make_loader(_csv_config(chain, n_threads=4, **kw))
    assert _epoch_draws(resumed, 2) == first[1]
    assert _epoch_draws(resumed, 1) == first[0]
    assert first[0] != first[1] and len(first[0]) == 16
    assert len({d[2] for d in first[0]}) > 1


_RANK_WORKER = r'''
import json
import sys

import torch.distributed as dist

from mmhand_torch.config import Config, DataConfig, ModelConfig
from mmhand_torch.parallel import init_distributed
from mmhand_torch.train.loop import make_loader

root, out = sys.argv[1], sys.argv[2]
init_distributed("cpu")
cfg = Config(model=ModelConfig(fine_size=%d),
             data=DataConfig(dataset="MMHand", pair_lst=root + "/pairs.csv",
                             image_root=root + "/img", pose_root=root + "/pose",
                             seed=3, batch_size=4, use_flip=True, n_threads=2))
loader = make_loader(cfg, dist.get_rank(), dist.get_world_size())
mine = [(s, t, float(h[:, :4].sum())) for raw in loader.epoch(1)
        for s, t, h in zip(raw["src_paths"], raw["tgt_paths"], raw["H1"])]
every = [None] * dist.get_world_size()
dist.all_gather_object(every, mine)
if dist.get_rank() == 0:
    with open(out, "w") as fh:
        json.dump(every, fh)
dist.destroy_process_group()
''' % SIZE


def test_ranks_draw_different_pairs_over_gloo(chain, tmp_path):
    """Two gloo ranks of the trainer's loader: each rank draws its own
    pairs, and together they draw the single process's epoch, in order."""
    import json

    from mmhand_torch.parallel.dryrun import launch
    from mmhand_torch.train.loop import make_loader

    worker = tmp_path / "worker.py"
    worker.write_text(_RANK_WORKER)
    out = tmp_path / "draws.json"
    launch([str(worker), str(chain), str(out)], 2, timeout=120,
           env={"OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)})
    ranks = [[tuple(d) for d in r] for r in json.loads(out.read_text())]
    assert len(ranks[0]) == len(ranks[1]) == 8 and ranks[0] != ranks[1]
    single = make_loader(_csv_config(chain, seed=3, batch_size=4,
                                     use_flip=True, n_threads=2))
    assert ranks[0] + ranks[1] == _epoch_draws(single, 1)


def test_chain_trains_two_steps_on_cpu(chain, tmp_path, capsys):
    """Raw RHD frames -> crops -> export -> pose maps -> two toy steps of
    ``scripts.train --dataset MMHand`` with a snapshot per step."""
    ckpt = str(tmp_path / "ckpt")
    argv = ["--dataset", "MMHand", "--imageroot", str(chain / "img"),
            "--poseroot", str(chain / "pose"),
            "--pairLst", str(chain / "pairs.csv"), "--use_flip",
            "--fineSize", str(SIZE), "--ngf", "8", "--ndf", "8",
            "--batchSize", "2", "--max_steps", "2", "--print_freq", "1",
            "--display_freq", "1", "--checkpoints_dir", ckpt, "--name", "csv",
            "--device", "cpu"]
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        result = ttrain.main(argv)
    assert result.steps == 2 and set(result.last_metrics) == LOSS_KEYS
    assert all(np.isfinite(v) for v in result.last_metrics.values())
    assert capsys.readouterr().out.count("(epoch: 1, iters: ") == 2
    images = os.listdir(os.path.join(ckpt, "csv", "web", "images"))
    assert len(images) == 2
    for net in ("netG", "netD_PB", "netD_PP"):
        assert os.path.exists(os.path.join(ckpt, "csv", f"latest_net_{net}.pth"))


def test_jax_chain_stops_at_a_missing_pose_map(tmp_path, jexport):
    """mmhand_tpu's own chain, raw frames to its dataset, stops at
    FileNotFoundError: its pose maps are named without the extension."""
    raw = write_raw_rhd(tmp_path / "raw", 4, seed=6)
    crops = str(tmp_path / "img" / "train")
    assert jpre.create_rhd_db(raw, crops, SIZE, workers=1) > 0
    jexport.export_pairs(crops, str(tmp_path / "pairs.csv"))
    jexport.export_keypoints(crops, str(tmp_path / "keypoints.csv"))
    jcsv.compute_pose_maps(str(tmp_path / "keypoints.csv"),
                           str(tmp_path / "pose" / "trainP"), (SIZE, SIZE))
    assert os.path.exists(tmp_path / "pose" / "trainP" / "color" / "00000.npy")
    ds = jcsv.MMHandCSVDataset(str(tmp_path / "img"), str(tmp_path / "pose"),
                               str(tmp_path / "pairs.csv"), seed=0)
    with pytest.raises(FileNotFoundError, match=r"\.png\.npy"):
        ds[0]
