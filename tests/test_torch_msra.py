"""The port's MSRA reader and pose search against mmhand_tpu's, on the CPU.

MSRA: ``.bin`` frames written as tests/test_aux2.py writes them and an
MSRA15-layout tree from ``data.raw_sources.write_raw_msra``; the reader,
pixel <-> world, ``read_joints``, the dataset's items, ``depthmap2points``
and ``voxel_sample`` (padded and trimmed clouds) equal mmhand_tpu's.

Pose search: ``pose_embedding`` and ``bone_difference_vectors`` equal
mmhand_tpu's; the searches run in float64 on the CPU, their distances within
1e-12 of mmhand_tpu's and their indices equal, or, where distances tie, the
same sets, with the lower database index first in the port.
"""

import struct

import numpy as np
import pytest

from mmhand_torch.data import msra as tm
from mmhand_torch.data.raw_sources import write_raw_msra
from mmhand_torch.eval import pose_search as tps
from mmhand_tpu.data import msra as jm
from mmhand_tpu.eval import pose_search as jps


def _write_msra_bin(path, img_w=320, img_h=240, left=100, top=80,
                    right=180, bottom=160, value=420.0):
    crop = np.full((bottom - top, right - left), value, np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack("I" * 6, img_w, img_h, left, top, right, bottom))
        f.write(crop.astype("<f4").tobytes())


def _equal_items(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("box,value", [((100, 80, 180, 160), 420.0),
                                       ((0, 0, 320, 240), 333.5),
                                       ((7, 3, 9, 200), 0.0)])
def test_depth_bin_matches_jax(tmp_path, box, value):
    path = str(tmp_path / "000000_depth.bin")
    _write_msra_bin(path, 320, 240, *box, value=value)
    depth, bbox = tm.load_depthmap_bin(path)
    want, want_box = jm.load_depthmap_bin(path)
    assert bbox == want_box == box
    assert depth.dtype == want.dtype
    np.testing.assert_array_equal(depth, want)


def test_camera_transforms_match_jax():
    rng = np.random.RandomState(0)
    x, y = rng.uniform(0, 320, 50), rng.uniform(0, 240, 50)
    z = rng.uniform(200, 700, 50)
    for got, want in zip(tm.pixel2world(x, y, z), jm.pixel2world(x, y, z)):
        np.testing.assert_array_equal(got, want)
    w = tm.pixel2world(x, y, z)
    for got, want in zip(tm.world2pixel(*w), jm.world2pixel(*w)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tm.world2pixel(*w)[0], x, rtol=1e-12)
    assert (tm.MSRA_FX, tm.MSRA_FY, tm.MSRA_IMG_WIDTH, tm.MSRA_IMG_HEIGHT) \
        == (241.42, 241.42, 320, 240)


@pytest.fixture
def tree(tmp_path):
    gdir = write_raw_msra(tmp_path / "msra", 5, seed=3)
    _write_msra_bin(str(tmp_path / "full.bin"), 320, 240, 0, 0, 320, 240,
                    value=350.0)
    return tmp_path, gdir


def test_read_joints_and_dataset_match_jax(tree):
    root, gdir = tree
    got = tm.read_joints(f"{gdir}/joint.txt")
    np.testing.assert_array_equal(got, jm.read_joints(f"{gdir}/joint.txt"))
    # z stored negated, read back positive
    assert got.shape == (5, 21, 3) and (got[..., 2] > 300).all()
    port = tm.MSRAHandDataset(str(root / "msra"))
    ref = jm.MSRAHandDataset(str(root / "msra"))
    assert len(port) == len(ref) == 5
    for i in range(5):
        _equal_items(port[i], ref[i])
    assert len(tm.MSRAHandDataset(str(root / "msra"), gestures=["2"])) == 0


def test_points_and_voxel_samples_match_jax(tree):
    """A hand of some 2000 points (padded with 1e9 to 32768) and a full
    frame of 76800 (trimmed)."""
    root, _ = tree
    item = tm.MSRAHandDataset(str(root / "msra"))[2]
    full = dict(item, depthmap=tm.load_depthmap_bin(str(root / "full.bin"))[0])
    for it, refpoint in ((item, None), (full, [1.0, -2.0, 350.0])):
        pts = tm.depthmap2points(it["depthmap"])
        np.testing.assert_array_equal(pts,
                                      jm.depthmap2points(it["depthmap"]))
        got = tm.voxel_sample(it, refpoint)
        _equal_items(got, jm.voxel_sample(it, refpoint))
        assert got["points"].shape == (32768, 3)
    assert 500 < (tm.voxel_sample(item)["points"][:, 2] < 1e9).sum() < 32768


def test_pose_embedding_matches_jax():
    rng = np.random.RandomState(1)
    xyz, uv = rng.normal(0, 50, (21, 3)), rng.uniform(0, 256, (21, 2))
    np.testing.assert_array_equal(tps.pose_embedding(xyz, uv),
                                  jps.pose_embedding(xyz, uv))
    line = np.stack([np.arange(21.0), 2 * np.arange(21.0)], 1)
    got = tps.pose_embedding(xyz, line)
    np.testing.assert_array_equal(got, jps.pose_embedding(xyz, line))
    assert got[-1] == 0.0  # a degenerate hull has no area
    np.testing.assert_array_equal(tps.bone_difference_vectors(xyz[None]),
                                  jps.bone_difference_vectors(xyz[None]))


def _database(n, seed, duplicates=0):
    """Random poses; with duplicates, rows equal to earlier ones (which tie
    with them) and a query near row 1, so that a tie leads the result."""
    rng = np.random.RandomState(seed)
    db = rng.normal(0, 40, (n, 21, 3))
    for i in range(duplicates):
        db[n - 1 - i] = db[3 * i + 1]
    q = (db[1] + rng.normal(0, 2, (21, 3)) if duplicates
         else rng.normal(0, 40, (21, 3)))
    return db, q


def _hold_knn(got, want, k):
    gi, gd = got
    wi, wd = want
    assert gi.shape == wi.shape == gd.shape == (k,)
    np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-12)
    assert (np.diff(gd) >= 0).all()
    # equal indices, or, over the positions where the port's distances tie,
    # the same set, lower index first; a tie cut by k may hold other members
    for d in np.unique(gd):
        at = np.flatnonzero(gd == d)
        assert (np.diff(gi[at]) > 0).all()
        if at[-1] < k - 1 or len(at) == 1:
            assert set(gi[at]) == set(wi[at]), (d, gi[at], wi[at])


@pytest.mark.parametrize("n,k,duplicates", [(500, 25, 0), (64, 25, 6),
                                            (10, 10, 2)])
def test_knn_pose_distance_matches_jax(n, k, duplicates):
    db, q = _database(n, n, duplicates)
    got = tps.knn_pose_distance(q, db, k, device="cpu")
    _hold_knn(got, jps.knn_pose_distance(q, db, k), k)
    assert tps.pose_distance(q, db[0], device="cpu") == pytest.approx(
        jps.pose_distance(q, db[0]), abs=1e-12)
    if duplicates:
        # row 1 and its duplicate lead, tied, the lower index first
        assert list(got[0][:2]) == [1, n - 1] and got[1][0] == got[1][1]


@pytest.mark.parametrize("duplicates", [0, 4])
def test_knn_embedding_matches_jax(duplicates):
    rng = np.random.RandomState(9)
    emb = rng.normal(0, 1, (300, 9))
    for i in range(duplicates):
        emb[299 - i] = emb[2 * i]
    q = emb[2] + rng.normal(0, 0.05, 9) if duplicates else rng.normal(0, 1, 9)
    got = tps.knn_embedding(q, emb, 40, device="cpu")
    _hold_knn(got, jps.knn_embedding(q, emb, 40), 40)
    if duplicates:
        assert list(got[0][:2]) == [2, 298] and got[1][0] == got[1][1]
    idx, d = tps.knn_embedding(emb[5], emb, 3, device="cpu")
    assert idx[0] == 5 and d[0] == 0.0
