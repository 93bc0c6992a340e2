"""The port's V2V voxelization against mmhand_tpu's, on the CPU.

The cases of tests/test_voxelize.py at its SIZES = (200.0, 16, 24), and at
(200.0, 32, 48) and the V2V transform's 64^3, the same numpy inputs through
``mmhand_tpu.ops.voxelize`` and ``mmhand_torch.ops.voxelize``:
``generate_coord`` and ``warp2continuous`` within 1e-4; ``scattering``,
``extract_coord_from_output`` and the three ``make_ellipsoid_mask`` cases
exactly; ``generate_cubic_hand`` exactly but for counted boundary voxels;
``generate_heatmap_gt`` within 1e-6; ``V2VVoxelization`` with the same
``RandomState`` seed: the same draws, the same outputs in both modes,
``evaluate`` within 1e-4 mm.

Boundary voxels: both packages compute in float32, in another order, so a
value that lies within rounding of a threshold may fall on either side of
it: a bone's quadric within 1e-5 of 1 (``make_ellipsoid_mask``'s n <= 1),
or a coordinate within 1e-4 of an integer (``scattering``'s truncation).
The tests count such voxels from a float64 evaluation and allow no other
difference.
"""

import numpy as np
import pytest
import torch

from mmhand_torch.ops import voxelize as tv
from mmhand_tpu.ops import voxelize as jv

SIZES = (200.0, 16, 24)  # cubic mm, cropped, original (tests/test_voxelize.py)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("new_size,angle", [
    (100.0, 0.0), (85.0, 0.3), (120.0, -0.4), (100.0, 0.7)])
def test_generate_coord_matches_jax(new_size, angle):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-80, 80, (50, 3)) + 100.0
    ref = np.array([100.0, 100.0, 100.0])
    trans = rng.uniform(0, 8, 3)
    want = np.asarray(jv.generate_coord(pts, ref, new_size, angle, trans,
                                        SIZES))
    got = tv.generate_coord(_t(pts), ref, new_size, angle, trans, SIZES)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_scattering_matches_jax_and_truncates_toward_zero():
    rng = np.random.RandomState(1)
    coord = rng.uniform(-4, 20, (100, 3)).astype(np.float32)
    # (-1, 0) lands in voxel 0, as the reference's astype(int32)
    coord[:3] = [[-0.5, 3.2, 4.7], [2.0, -0.99, 0.1], [15.999, 15.0, -0.01]]
    want = np.asarray(jv.scattering(coord, 16))
    got = tv.scattering(_t(coord), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 3, 4] == 1 and got[2, 0, 0] == 1 and got[15, 15, 0] == 1


@pytest.mark.parametrize("radii,angle", [
    ([3.0, 3.0, 3.0], [80.0, 30.0, 20.0]),   # spherical (hand bones)
    ([5.0, 2.0, 3.0], [0.0, 0.0, 0.0]),      # axis-aligned ellipsoid
    ([5.0, 2.0, 3.0], [25.0, -10.0, 40.0]),  # rotated ellipsoid
])
def test_ellipsoid_mask_matches_jax(radii, angle):
    size, center = 16, [7.2, 5.5, 9.1]
    want = np.asarray(jv.make_ellipsoid_mask(size, center, radii,
                                             np.deg2rad(angle)))
    got = tv.make_ellipsoid_mask(size, center, radii, np.deg2rad(angle),
                                 device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_rotation_matrix_matches_jax():
    a = np.deg2rad([25.0, -10.0, 40.0]).astype(np.float32)
    for inverse in (False, True):
        want = np.asarray(jv.build_rotation_matrix(*a, inverse=inverse))
        got = tv.build_rotation_matrix(*_t(a).unbind(), inverse=inverse)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_warp_roundtrip_matches_jax():
    rng = np.random.RandomState(2)
    ref = np.array([30.0, -20.0, 400.0])
    world = rng.uniform(-90, 90, (21, 3)) + ref
    sizes = (200.0, 64, 64)
    coord = tv.generate_coord(_t(world), ref, 100.0, 0.0, np.zeros(3), sizes)
    want_coord = np.asarray(jv.generate_coord(world, ref, 100.0, 0.0,
                                              np.zeros(3), sizes))
    np.testing.assert_allclose(coord.numpy(), want_coord, rtol=0, atol=1e-4)
    back = tv.warp2continuous(torch.floor(coord) + 0.5, ref, 200.0, 64)
    want = np.asarray(jv.warp2continuous(np.floor(want_coord) + 0.5, ref,
                                         200.0, 64))
    np.testing.assert_allclose(back.numpy(), want, rtol=0, atol=1e-4)
    assert float((back - _t(world)).abs().max()) <= 200.0 / 64
    np.testing.assert_allclose(
        tv.discretize(_t([-1.0, 0.0, 1.0]), 64).numpy(),
        np.asarray(jv.discretize(np.float32([-1.0, 0.0, 1.0]), 64)))


def test_extract_coord_matches_jax_and_takes_the_first_maximum():
    rng = np.random.RandomState(3)
    hm = rng.uniform(0, 1, (2, 5, 8, 8, 8)).astype(np.float32)
    hm[0, 0] = 0.5                      # every voxel ties
    hm[1, 2, 3, 4, 5] = hm[1, 2, 6, 1, 0] = 2.0
    for center in (True, False):
        want = np.asarray(jv.extract_coord_from_output(hm, center))
        got = tv.extract_coord_from_output(torch.from_numpy(hm), center)
        np.testing.assert_array_equal(got.numpy(), want)
    got = tv.extract_coord_from_output(torch.from_numpy(hm), False)
    assert got[0, 0].tolist() == [0, 0, 0] and got[1, 2].tolist() == [3, 4, 5]


def _quadric64(coord, size):
    """Each bone's quadric at every voxel in float64 from ``coord`` (the
    keypoints' voxel coordinates): (15, size, size, size)."""
    c = np.asarray(coord, np.float64)
    j1, j2 = c[tv.CONNECTIONS[:, 0]], c[tv.CONNECTIONS[:, 1]]
    d = np.sqrt(((j1 - j2) ** 2).sum(1))
    centers = np.abs(j1 - j2) / 2 + np.minimum(j1, j2)
    radii = np.repeat((d / 2.5)[:, None], 3, 1)
    a = -np.deg2rad(np.array(tv.BONE_ROTATION))
    r = np.asarray(tv.build_rotation_matrix(*torch.tensor(a).unbind()))
    g = np.arange(size, dtype=np.float64)
    off = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1)
    off = off[None] - centers[:, None, None, None]
    e = np.einsum("de,kxyze->kxyzd", r, off)
    return ((e / radii[:, None, None, None]) ** 2).sum(-1)


def _near_integer_voxels(coord, size, tol=1e-4):
    """Voxels a point whose coordinate lies within ``tol`` of an integer may
    land in, on either side."""
    out = set()
    for p in np.asarray(coord, np.float64):
        options = [{int(np.floor(v - tol)), int(np.floor(v + tol))}
                   if abs(v - round(v)) < tol else {int(np.floor(v))}
                   for v in p]
        if all(len(o) == 1 for o in options):
            continue
        out |= {(a, b, c) for a in options[0] for b in options[1]
                for c in options[2]
                if min(a, b, c) >= 0 and max(a, b, c) < size}
    return out


def _hold_hand(got, want, coord, size):
    """Equal but for voxels on a bone's boundary or under a keypoint on a
    voxel edge; returns how many differ."""
    diff = np.argwhere(got != want)
    if len(diff) == 0:
        return 0
    q = _quadric64(coord, size)
    edge = _near_integer_voxels(coord, size)
    for v in map(tuple, diff):
        on_boundary = bool((np.abs(q[(slice(None),) + v] - 1.0) < 1e-5).any())
        assert on_boundary or v in edge, f"voxel {v} differs off any boundary"
    return len(diff)


@pytest.mark.parametrize("sizes,new_size,angle", [
    (SIZES, 100.0, 0.0), (SIZES, 85.0, 0.3),
    ((200.0, 32, 48), 100.0, 0.0), ((200.0, 32, 48), 112.0, -0.5)])
def test_cubic_hand_matches_jax(sizes, new_size, angle):
    rng = np.random.RandomState(4)
    ref = np.zeros(3)
    kp = rng.uniform(-60, 60, (21, 3))
    t = np.full(3, (sizes[2] - sizes[1]) / 2)
    want = np.asarray(jv.generate_cubic_hand(kp, ref, new_size, angle, t,
                                             sizes))
    got = tv.generate_cubic_hand(_t(kp), ref, new_size, angle, t, sizes)
    coord = np.asarray(jv.generate_coord(kp, ref, new_size, angle, t, sizes))
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}
    assert _hold_hand(got.numpy(), want, coord, sizes[1]) <= 4
    assert want.sum() > 21


def test_cubic_input_matches_jax():
    rng = np.random.RandomState(6)
    ref = np.array([0.0, 0.0, 350.0])
    pts = rng.uniform(-90, 90, (500, 3)) + ref
    t = rng.uniform(0, 8, 3)
    want = np.asarray(jv.generate_cubic_input(pts, ref, 90.0, 0.2, t, SIZES))
    got = tv.generate_cubic_input(_t(pts), ref, 90.0, 0.2, t, SIZES).numpy()
    coord = np.asarray(jv.generate_coord(pts, ref, 90.0, 0.2, t, SIZES))
    edge = _near_integer_voxels(coord, SIZES[1])
    assert all(tuple(v) in edge for v in np.argwhere(got != want))


@pytest.mark.parametrize("sizes", [(200.0, 32, 48), SIZES])
def test_heatmap_gt_matches_jax(sizes):
    ref = np.zeros(3)
    kp = np.array([[10.0, -20.0, 40.0], [-30.0, 5.0, -12.5]])
    t = np.full(3, (sizes[2] - sizes[1]) / 2)
    want = np.asarray(jv.generate_heatmap_gt(kp, ref, 100.0, 0.0, t, sizes,
                                             pool_factor=2, std=1.7))
    got = tv.generate_heatmap_gt(_t(kp), ref, 100.0, 0.0, t, sizes,
                                 pool_factor=2, std=1.7)
    assert got.shape == want.shape == (2,) + (sizes[1] // 2,) * 3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _sample(seed, n_points=300):
    rng = np.random.RandomState(seed)
    ref = np.array([0.0, 0.0, 350.0])
    return {"points": (rng.uniform(-90, 90, (n_points, 3)) + ref).astype(
                np.float32),
            "keypoints": (rng.uniform(-80, 80, (21, 3)) + ref).astype(
                np.float32),
            "refpoint": ref.astype(np.float32)}


@pytest.mark.parametrize("augmentation", [False, True])
def test_v2v_transform_matches_jax(augmentation):
    """Three samples through both transforms with RandomState(0): the same
    draws, the same cubes (but for counted boundary voxels) and
    coordinates within 1e-4 voxel."""
    port = tv.V2VVoxelization(200.0, augmentation, np.random.RandomState(0),
                              device="cpu")
    ref = jv.V2VVoxelization(200.0, augmentation, np.random.RandomState(0))
    differing = 0
    for seed in range(3):
        sample = _sample(seed)
        draws = jv.V2VVoxelization(200.0, augmentation,
                                   _rng_at(port.rng.get_state()))._draws()
        inp, coords, hand = port(sample)
        want_inp, want_coords, want_hand = map(np.asarray, ref(sample))
        got_state, want_state = port.rng.get_state(), ref.rng.get_state()
        np.testing.assert_array_equal(got_state[1], want_state[1])
        assert got_state[2] == want_state[2]
        assert inp.shape == hand.shape == (1, 64, 64, 64)
        np.testing.assert_allclose(coords.numpy(), want_coords, rtol=0,
                                   atol=1e-4)
        point_coord = np.asarray(jv.generate_coord(
            sample["points"], sample["refpoint"], *draws, ref.sizes))
        edge = _near_integer_voxels(point_coord, 64)
        assert all(tuple(v) in edge
                   for v in np.argwhere(inp.numpy()[0] != want_inp[0]))
        differing += _hold_hand(hand.numpy()[0], want_hand[0], want_coords,
                                64)
        assert want_hand.sum() > 21
    assert differing <= 8


def _rng_at(state):
    rng = np.random.RandomState()
    rng.set_state(state)
    return rng


def test_v2v_heatmap_voxelize_and_evaluate_match_jax():
    """The heatmaps within 1e-6 of mmhand_tpu's ``generate_heatmap_gt`` run
    eagerly with the transform's arguments.  Its transform jits that
    function, and XLA's fused arithmetic moves the coordinates by a few
    ulps; against it the heatmaps are held to the Gaussian's slope times
    the coordinates' own difference."""
    sample = _sample(5, 200)
    port = tv.V2VVoxelization(200.0, augmentation=False, device="cpu")
    ref = jv.V2VVoxelization(200.0, augmentation=False)
    kp, refpoint = sample["keypoints"], sample["refpoint"]
    hm = port.generate_heatmap(kp, refpoint).numpy()
    centred = np.full(3, 16.0)
    eager = np.asarray(jv.generate_heatmap_gt(kp, refpoint, 100.0, 0.0,
                                              centred, ref.sizes, 2, 1.7))
    np.testing.assert_allclose(hm, eager, rtol=0, atol=1e-6)
    want_hm = np.asarray(ref.generate_heatmap(kp, refpoint))
    coord_gap = float(np.abs(
        tv.generate_coord(_t(kp), refpoint, 100.0, 0.0, centred,
                          ref.sizes).numpy()
        - np.asarray(ref._coord(kp, refpoint, 100.0, 0.0, centred))).max())
    # |d exp(-|x|^2 / 2) / dx| <= e^(-1/2) per axis, x = coord / (2 * 1.7)
    slope = np.sqrt(3.0) * np.exp(-0.5) / (2 * 1.7)
    np.testing.assert_allclose(hm, want_hm, rtol=0,
                               atol=1e-6 + slope * coord_gap)
    np.testing.assert_array_equal(
        port.voxelize(sample["points"], refpoint).numpy(),
        np.asarray(ref.voxelize(sample["points"], refpoint)))
    back = port.evaluate(want_hm, refpoint)
    want = np.asarray(ref.evaluate(want_hm, refpoint))
    np.testing.assert_allclose(back.numpy(), want, rtol=0, atol=1e-4)
    assert float(np.abs(back.numpy() - kp).max()) < 2 * 200.0 / 64


def test_augmentation_draws_are_the_references():
    port = tv.V2VVoxelization(200.0, True, np.random.RandomState(7),
                              device="cpu")
    ref = jv.V2VVoxelization(200.0, True, np.random.RandomState(7))
    for _ in range(20):
        got, want = port._draws(), ref._draws()
        assert got[0] == want[0] and got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        assert 80 <= got[0] <= 120 and abs(got[1]) <= 40 / 180 * np.pi
