"""The port's RHD and STB preprocessing against mmhand_tpu's.

Both packages build crop trees from the same raw sources
(``mmhand_torch.data.raw_sources``): the crops must be the same files byte
for byte and the annotations equal to 1e-12.  The RHD source holds two-hand
frames, hands rejected for an invisible keypoint and masks the
false-positive filter drops.  One divergence is deliberate: mmhand_tpu files
an STB image as train whenever ``/train/`` occurs in its destination path,
so with a ``dst`` under a folder named ``train`` its B4 crops are annotated
as train; the port takes the split from the sequence.
"""

import filecmp
import os
import pickle

import numpy as np
import pytest
import torch

from mmhand_torch.data import preprocess as tpre
from mmhand_torch.data.raw_sources import write_raw_rhd, write_raw_stb
from mmhand_torch.ops import image as timage
from mmhand_torch.scripts import create_rhd_db as rhd_cli
from mmhand_torch.scripts import create_stb_db as stb_cli
from mmhand_tpu.data import preprocess as jpre
from mmhand_tpu.ops import image as jimage

SIZE = 32
N_RHD = 16  # frames: 32 hands, 8 rejected, 4 filtered -> 20 crops
N_STB = 3   # frames per camera view and sequence


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads while this file runs: the suite runs several
    files at once."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def rhd_src(tmp_path_factory):
    return write_raw_rhd(tmp_path_factory.mktemp("raw") / "rhd", N_RHD, seed=3)


@pytest.fixture(scope="module")
def stb_src(tmp_path_factory):
    return write_raw_stb(tmp_path_factory.mktemp("raw") / "stb", N_STB, seed=4)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def assert_trees_equal(got, want):
    """Same nested keys; arrays equal to 1e-12, everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            assert_trees_equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    else:
        assert got == want


def assert_same_files(got_dir, want_dir):
    """Every file under ``want_dir`` is under ``got_dir``, byte for byte,
    and nothing else is."""
    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files)
    names = listing(want_dir)
    assert names == listing(got_dir)
    for name in names:
        if not name.endswith(".pickle"):
            assert filecmp.cmp(os.path.join(got_dir, name),
                               os.path.join(want_dir, name), shallow=False), name
    return names


def test_crop_geometry_matches_jax():
    rng = np.random.RandomState(0)
    uv = rng.uniform(-10, 330, (21, 2))
    box = timage.bbox_from_uv(uv, (320, 300))
    assert box == jimage.bbox_from_uv(uv, (320, 300))
    k = rng.uniform(0, 600, (3, 3))
    xmin, xmax, ymin, ymax = box
    np.testing.assert_array_equal(
        timage.rescale_intrinsics(k, xmin, ymin, xmax, ymax, 64),
        jimage.rescale_intrinsics(k, xmin, ymin, xmax, ymax, 64))
    np.testing.assert_array_equal(
        timage.rescale_uv(uv, xmin, ymin, xmax, ymax, 64),
        jimage.rescale_uv(uv, xmin, ymin, xmax, ymax, 64))
    uv32 = uv.astype(np.float32)
    got = timage.flip_uv_x(uv32, 64)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jimage.flip_uv_x(uv32, 64)))
    # float64 stays float64: mmhand_tpu's preprocessing formula, inline
    got = timage.flip_uv_x(uv, 64)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got[:, 0], uv[:, 0] + 2.0 * (32.0 - uv[:, 0]))
    np.testing.assert_array_equal(got[:, 1], uv[:, 1])
    assert timage.BBOX_MARGIN == jimage.BBOX_MARGIN


def test_constants_match_jax():
    assert tpre.RHD_ORDER == jpre.RHD_ORDER
    assert tpre.STB_TO_STD == jpre.STB_TO_STD
    for name in ("STB_BB_K", "STB_SK_K_COLOR", "STB_SK_K_DEPTH",
                 "STB_SK_R_COLOR", "STB_SK_T_COLOR"):
        np.testing.assert_array_equal(getattr(tpre, name), getattr(jpre, name))
    assert tpre.STB_BB_BASE == jpre.STB_BB_BASE
    assert (tpre.STB_TRAIN_SEQS, tpre.STB_TEST_SEQS) == (
        jpre.STB_TRAIN_SEQS, jpre.STB_TEST_SEQS)


def test_project_points_matches_jax():
    rng = np.random.RandomState(1)
    xyz = rng.uniform(-50, 50, (21, 3)) + [0, 0, 500]
    rvec, tvec = rng.normal(0, 0.3, 3), rng.normal(0, 20, 3)
    k = np.array([[600.0, 0, 320], [0, 610.0, 240], [0, 0, 1]])
    got = tpre.project_points(xyz, rvec, tvec, k)
    np.testing.assert_array_equal(got, jpre.project_points(xyz, rvec, tvec, k))
    # a quarter turn about z: (1, 0, 5) -> (0, 1, 5)
    quarter = tpre.project_points(np.array([[1.0, 0.0, 5.0]]),
                                  np.array([0, 0, np.pi / 2]), np.zeros(3),
                                  np.eye(3))
    np.testing.assert_allclose(quarter, [[0.0, 0.2]], atol=1e-12)


@pytest.mark.parametrize("camera,mode", [("SK", "color"), ("SK", "depth"),
                                         ("BB", "left"), ("BB", "right")])
def test_stb_uv_coord_and_k_match_jax(camera, mode):
    xyz = np.random.RandomState(2).uniform(-30, 30, (21, 3)) + [40, 0, 500]
    np.testing.assert_array_equal(tpre.stb_uv_coord(mode, camera, xyz),
                                  jpre.stb_uv_coord(mode, camera, xyz))
    np.testing.assert_array_equal(tpre._stb_k_for(camera, mode),
                                  jpre._stb_k_for(camera, mode))


def test_stb_k_depth_quirk_and_bad_camera():
    """An SK color crop files K_depth, as the reference does."""
    np.testing.assert_array_equal(tpre._stb_k_for("SK", "color"),
                                  tpre.STB_SK_K_DEPTH)
    with pytest.raises(ValueError, match="bad camera"):
        tpre.stb_uv_coord("color", "BB", np.zeros((21, 3)))


def test_rhd_crops_equal_jax(rhd_src, tmp_path, capsys):
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    n = rhd_cli.main([rhd_src, got_dir, str(SIZE), "--workers", "3"])
    assert "wrote 20 crops" in capsys.readouterr().out
    assert n == jpre.create_rhd_db(rhd_src, want_dir, SIZE, workers=2) == 20
    names = assert_same_files(got_dir, want_dir)
    assert len(names) == 3 * 20 + 1
    got = _load(os.path.join(got_dir, "annotation.pickle"))
    assert_trees_equal(got, _load(os.path.join(want_dir, "annotation.pickle")))
    # every crop's keypoints lie inside it
    for anno in got["color"].values():
        assert 0 <= anno["uv_coord"].min() and anno["uv_coord"].max() <= SIZE


def test_rhd_split_reject_and_filter(rhd_src, tmp_path):
    """The source's frames 0-3: two hands, right rejected, left rejected,
    two hands; frame 7 has no hand in its mask.  The crops come in frame
    order, left before right, and the right hand's crop is mirrored."""
    dst = str(tmp_path / "crop")
    tpre.create_rhd_db(rhd_src, dst, SIZE, workers=2, limit=8)
    annos = _load(os.path.join(dst, "annotation.pickle"))
    assert sorted(annos) == ["color", "depth", "mask"]
    assert len(annos["color"]) == 2 + 1 + 1 + 2 + 2 + 1 + 1 + 0
    with open(os.path.join(rhd_src, "evaluation", "anno_evaluation.pickle"),
              "rb") as f:
        raw = pickle.load(f)
    right = raw[0]["uv_vis"][21:, :2][tpre.RHD_ORDER]
    box = timage.bbox_from_uv(right, tpre.RHD_FRAME)
    uv = timage.rescale_uv(right, box[0], box[2], box[1], box[3], SIZE)
    np.testing.assert_allclose(annos["color"]["00001.png"]["uv_coord"],
                               timage.flip_uv_x(uv, SIZE), atol=1e-4)
    np.testing.assert_array_equal(annos["color"]["00001.png"]["xyz"],
                                  raw[0]["xyz"][21:][tpre.RHD_ORDER])


def test_stb_crops_equal_jax(stb_src, tmp_path, capsys):
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    counts = stb_cli.main([stb_src, got_dir, str(SIZE), "--workers", "3"])
    assert "'train': 9, 'test': 9" in capsys.readouterr().out
    assert counts == jpre.create_stb_db(stb_src, want_dir, SIZE, workers=2) == {
        "train": 3 * N_STB, "test": 3 * N_STB}
    assert_same_files(got_dir, want_dir)
    for split in ("train", "test"):
        got = _load(os.path.join(got_dir, split, "annotation.pickle"))
        assert_trees_equal(
            got, _load(os.path.join(want_dir, split, "annotation.pickle")))
        for folder in got.values():
            for anno in folder.values():
                assert 0 <= anno["uv_coord"].min()
                assert anno["uv_coord"].max() <= SIZE


def test_stb_split_ignores_a_train_folder_in_dst(stb_src, tmp_path):
    """With ``dst`` under ``train/``, B4 still goes to test, crops and
    annotations alike; mmhand_tpu annotates its B4 crops as train there."""
    dst = str(tmp_path / "train" / "out")
    # --limit 2 keeps two SK and two BB images per sequence
    counts = tpre.create_stb_db(stb_src, dst, SIZE, workers=2, limit=2)
    assert counts == {"train": 4, "test": 4}
    test = _load(os.path.join(dst, "test", "annotation.pickle"))
    assert list(test) == ["B4Counting"]
    for image in test["B4Counting"]:
        assert os.path.isfile(os.path.join(dst, "test", "B4Counting", image))
    assert list(_load(os.path.join(dst, "train", "annotation.pickle"))) == [
        "B1Counting"]
    jax_dst = str(tmp_path / "train" / "jax")
    assert jpre.create_stb_db(stb_src, jax_dst, SIZE, workers=2, limit=2) == {
        "train": 8, "test": 0}
