"""The port's jointsmap (K3's plain version) and ``create_input_image``
against mmhand_tpu.

The plain version keeps mmhand_tpu's operation order, one float32 rounding
per operation, so it must equal both ``generate_jointsmap`` (XLA) and
``generate_jointsmap_pallas`` (interpret mode on the CPU) exactly: atol 0.
"""

import numpy as np
import pytest
import torch

from mmhand_torch.eval.evaluator import Evaluator as TorchEvaluator
from mmhand_torch.ops import jointsmap as tjm
from mmhand_tpu.eval import Evaluator as JaxEvaluator
from mmhand_tpu.ops import jointsmap as jjm


def _poses(batch, height, width, seed=0):
    """Hand-sized poses inside the frame, depths in the crop tree's scale."""
    rng = np.random.RandomState(seed)
    scale = np.array([width, height], np.float32)
    centre = rng.uniform(0.3, 0.7, (batch, 1, 2)) * scale
    uv = (centre + rng.normal(0, 0.18, (batch, 21, 2)) * scale).astype(np.float32)
    z = rng.uniform(300, 700, (batch, 21)).astype(np.float32) / 700 * 255
    return uv, z.astype(np.float32)


def _occlusion():
    """tests/test_ops.py's crossing bones: the near one wins the crossing."""
    uv = np.zeros((21, 2), np.float32)
    depth = np.full((21,), 1.0e6, np.float32)
    uv[1], uv[2] = [20, 128], [236, 128]
    depth[1] = depth[2] = 0.2
    uv[5], uv[6] = [128, 20], [128, 236]
    depth[5] = depth[6] = 0.8
    uv[0] = uv[3:5] = uv[7:] = [-500, -500]
    return uv, depth


def _tie():
    """Equal depths everywhere: the later bone wins every overlap."""
    uv, _ = _poses(1, 256, 256, seed=5)
    return uv[0], np.full((21,), 100.0, np.float32)


def _zero_length():
    """Bones of zero length (joints on top of each other): the 1e-6 and
    1e-3 guards."""
    uv, z = _poses(1, 256, 256, seed=6)
    uv, z = uv[0], z[0]
    uv[2] = uv[1]
    uv[18] = uv[19] = uv[20] = uv[17]
    return uv, z


def _parked():
    """Most joints parked far off the frame, one bone on its edge."""
    uv, z = _poses(1, 256, 256, seed=7)
    uv, z = uv[0], z[0]
    uv[5:] = [-1000.0, 4000.0]
    uv[1], uv[2] = [0.0, 255.0], [255.0, 255.0]
    return uv, z


CASES = {"occlusion": _occlusion, "tie": _tie, "zero_length": _zero_length,
         "parked": _parked}


def _port(uv, z, height, width):
    return tjm.generate_jointsmap(torch.from_numpy(uv), torch.from_numpy(z),
                                  height, width).numpy()


@pytest.mark.parametrize("batch,height,width", [(4, 256, 256), (3, 70, 90)])
def test_plain_equals_xla_and_pallas(batch, height, width):
    uv, z = _poses(batch, height, width)
    got = _port(uv, z, height, width)
    assert got.shape == (batch, height, width) and got.dtype == np.float32
    xla = np.asarray(jjm.generate_jointsmap(uv, z, height, width))
    pallas = np.asarray(jjm.generate_jointsmap_pallas(uv, z, height, width))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    # the poses cover a fair part of the frame with several bones
    assert (got > 0).mean() > 0.05 and len(np.unique(got)) > 10


@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_cases_equal_xla_and_pallas(case):
    uv, z = CASES[case]()
    got = _port(uv, z, 256, 256)
    np.testing.assert_array_equal(got, np.asarray(
        jjm.generate_jointsmap(uv, z, 256, 256)))
    np.testing.assert_array_equal(got[None], np.asarray(
        jjm.generate_jointsmap_pallas(uv[None], z[None], 256, 256)))
    if case == "occlusion":
        assert got[128, 128] == 10.0 and got[40, 128] == 40.0


def test_tie_goes_to_the_later_bone():
    # parked joints share one point: their zero-length bones have cos =
    # sin = 0 and cover the whole frame, far behind at depth 1e6
    uv = np.full((21, 2), -500.0, np.float32)
    z = np.full((21,), 1.0e6, np.float32)
    uv[1], uv[2] = [10, 32], [54, 32]     # bone 8, colour 10
    uv[5], uv[6] = [10, 32], [54, 32]     # bone 11, the same segment, colour 40
    z[[1, 2, 5, 6]] = 50.0
    got = _port(uv, z, 64, 64)
    assert got[32, 32] == 40.0 and got[5, 5] == 120.0
    z[5] = z[6] = 50.5                    # now the earlier bone is nearer
    assert _port(uv, z, 64, 64)[32, 32] == 10.0


def test_lead_dimensions():
    uv, z = _poses(6, 48, 40, seed=2)
    uv, z = uv.reshape(2, 3, 21, 2), z.reshape(2, 3, 21)
    got = _port(uv, z, 48, 40)
    assert got.shape == (2, 3, 48, 40)
    np.testing.assert_array_equal(got, np.asarray(
        jjm.generate_jointsmap(uv, z, 48, 40)))
    np.testing.assert_array_equal(got[1, 2], _port(uv[1, 2], z[1, 2], 48, 40))


def test_bone_params_match():
    uv, z = _zero_length()
    got = tjm.bone_params(torch.from_numpy(uv), torch.from_numpy(z))
    want = jjm._bone_params(uv, z)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tjm.HAND_BONES == jjm.HAND_BONES
    assert tjm.BONE_COLORS == jjm.BONE_COLORS


def test_dispatch_counts_no_cpu_launch():
    uv, z = _poses(1, 32, 32)
    before = tjm.generate_jointsmap.launches
    _port(uv, z, 32, 32)
    assert tjm.generate_jointsmap.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        tjm.generate_jointsmap(torch.zeros(1, 21, 2, device="meta"),
                               torch.zeros(1, 21, device="meta"))


@pytest.mark.parametrize("size", [256, 32])
def test_create_input_image_matches_jax(size):
    uv, z = _poses(3, size, size, seed=4)
    xyz = np.concatenate([uv, z[..., None]], axis=-1)
    got = TorchEvaluator.create_input_image(torch.from_numpy(xyz), size)
    want = JaxEvaluator.create_input_image(xyz, size)
    assert isinstance(got, torch.Tensor) and got.shape == (3, size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # one pose without a batch dimension
    one = TorchEvaluator.create_input_image(torch.from_numpy(xyz[1]), size)
    np.testing.assert_array_equal(one.numpy(), got.numpy()[1:2])
