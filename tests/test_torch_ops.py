"""mmhand_torch ops and batch preparation against their mmhand_tpu twins.

Inputs are made with numpy from a seed and go through both packages on the
CPU.  The JAX Pallas heatmap kernel runs in interpret mode, as
tests/test_ops.py runs it.
"""

import math

import numpy as np
import pytest
import torch

from mmhand_torch.data.loader import make_prepare_batch
from mmhand_torch.ops import depth as tdepth
from mmhand_torch.ops import heatmap
from mmhand_torch.ops import image as timage
from mmhand_torch.ops.heatmap import (
    CLIP_LO,
    gaussian_heatmaps,
    gaussian_heatmaps_ref,
)
from mmhand_torch.utils import trace
from mmhand_tpu import ops as jops
from mmhand_tpu.data.loader import make_prepare_batch as jax_prepare_batch
from test_torch_cuda import HEAT_SKIP_CASES, _heatmap_skip_case

# Heatmaps: atol 1e-5, as tests/test_ops.py holds the Pallas kernel against
# the XLA version.  Pixels whose unclipped Gaussian lies within 1e-6 of the
# 0.0099 clip are exempt: there a last-bit difference between two exp
# implementations flips the clip, a jump of 0.0099.
HEAT_ATOL = 1e-5


def _clip_boundary(uv, height, width, sigma=6.0):
    """(B, H, W, K) mask of pixels within 1e-6 of the clip (float64)."""
    rows = np.arange(height, dtype=np.float64)[:, None, None]
    cols = np.arange(width, dtype=np.float64)[None, :, None]
    uv = np.asarray(uv, np.float64)
    d2 = ((cols - uv[:, None, None, :, 0]) ** 2
          + (rows - uv[:, None, None, :, 1]) ** 2)
    return np.abs(np.exp(-d2 / (2 * sigma * sigma)) - CLIP_LO) <= 1e-6


def assert_heatmaps_close(got, want, uv, height, width):
    exempt = _clip_boundary(uv, height, width)
    assert exempt.mean() < 1e-3
    np.testing.assert_allclose(np.where(exempt, 0, got),
                               np.where(exempt, 0, want), atol=HEAT_ATOL)


def test_normalize_image_exact():
    img = np.random.RandomState(0).randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    got = timage.normalize_image(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.normalize_image(img)))


def test_denormalize_image_exact():
    """Clip then truncate: values from below -1 to above 1, and the exact
    level boundaries."""
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 500),
                        np.arange(256) / 127.5 - 1.0]).astype(np.float32)
    got = timage.denormalize_image(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(jops.denormalize_image(x)))


def test_depth_decode_exact():
    rgb = np.random.RandomState(2).randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    got = tdepth.depth_to_rgb_planes(tdepth.decode_depth_gan(torch.from_numpy(rgb)))
    want = jops.depth_to_rgb_planes(jops.decode_depth_gan(rgb))
    assert tdepth.GAN_DEPTH_SCALE == 700.0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the tests/test_ops.py:39-54 cases: (seed, coordinate range, size)
HEAT_CASES = [(0, (5, 59), 64), (1, (5, 250), 256)]


@pytest.mark.parametrize("seed,lo_hi,size", HEAT_CASES)
@pytest.mark.parametrize("jax_fn", ["gaussian_heatmaps",
                                    "gaussian_heatmaps_pallas"])
def test_heatmaps_ref_matches_jax(seed, lo_hi, size, jax_fn):
    uv = np.random.RandomState(seed).uniform(*lo_hi, size=(2, 21, 2)
                                             ).astype(np.float32)
    want = np.asarray(getattr(jops, jax_fn)(uv, size, size, 6.0))
    got = gaussian_heatmaps_ref(torch.from_numpy(uv), size, size, 6.0).numpy()
    assert got.shape == want.shape == (2, size, size, 21)
    assert_heatmaps_close(got, want, uv, size, size)


def test_heatmaps_ragged_and_off_frame():
    """A non-square frame and keypoints outside it, against the XLA version."""
    uv = np.random.RandomState(3).uniform(-10, 100, size=(3, 21, 2)
                                          ).astype(np.float32)
    want = np.asarray(jops.gaussian_heatmaps(uv, 70, 90, 6.0))
    got = gaussian_heatmaps_ref(torch.from_numpy(uv), 70, 90, 6.0).numpy()
    assert_heatmaps_close(got, want, uv, 70, 90)


@pytest.mark.parametrize("case", HEAT_SKIP_CASES)
@pytest.mark.parametrize("sigma", [5.0, 6.0])
def test_heatmap_early_out_skips_only_zeros(case, sigma):
    """Every element whose d^2 reaches the kernel's threshold (from the
    wrapper's own helper) is exactly 0 in the plain version, and in the XLA
    version: the early-out cannot change an output."""
    height, width = 48, 64
    uv = _heatmap_skip_case(case, sigma, 3, height, width)
    skipped = heatmap.skipped_elements(uv, height, width, sigma)
    want = gaussian_heatmaps_ref(uv, height, width, sigma)
    assert skipped.shape == want.shape
    assert not bool(want[skipped].any())
    xla = np.asarray(jops.gaussian_heatmaps(uv.numpy(), height, width, sigma))
    assert not xla[skipped.numpy()].any()
    # most elements are skipped, and the threshold is tight: the clip also
    # zeroes some elements it leaves to exp
    assert float(skipped.float().mean()) > 0.5
    assert bool(((want == 0) & ~skipped).any())
    if case == "near_threshold":
        x, y = uv[..., 0].double(), uv[..., 1].double()
        d2 = (30.0 - x) ** 2 + (10.0 - y) ** 2
        t = float(np.float32(heatmap.skip_d2(sigma)))
        assert float((d2 / t - 1).abs().max()) < 1e-6


def test_heatmap_skip_threshold():
    """T = 2 sigma^2 (ln(1/0.0099) + 0.05): where d^2 >= T, exp is under
    0.0095, ~4% below the clip."""
    assert heatmap.skip_d2(6.0) == pytest.approx(335.9, abs=0.1)
    for sigma in (1.0, 5.0, 6.0, 11.0):
        assert math.exp(-heatmap.skip_d2(sigma) / (2 * sigma ** 2)) < 0.96 * CLIP_LO


def test_heatmap_wrapper_dispatch():
    """A CPU tensor takes the plain version and launches nothing; a device
    without a kernel raises rather than falling back."""
    uv = torch.from_numpy(np.random.RandomState(4).uniform(
        5, 27, (2, 21, 2)).astype(np.float32))
    before = trace.counters().get("k1.launches", 0)
    got = gaussian_heatmaps(uv, 32, 32, 6.0)
    assert torch.equal(got, gaussian_heatmaps_ref(uv, 32, 32, 6.0))
    assert trace.counters().get("k1.launches", 0) == before
    with pytest.raises(ValueError):
        gaussian_heatmaps(uv.to("meta"), 32, 32, 6.0)


def _raw_batch(seed=5, batch=2, size=32):
    rng = np.random.RandomState(seed)
    raw = {}
    for side in ("src", "tgt"):
        raw[f"{side}_image"] = rng.randint(0, 256, (batch, size, size, 3)
                                           ).astype(np.uint8)
        raw[f"{side}_depth"] = rng.randint(0, 700, (batch, size, size)
                                           ).astype(np.uint16)
        raw[f"{side}_uv"] = rng.uniform(4, size - 4, (batch, 21, 2)
                                        ).astype(np.float32)
        raw[f"{side}_z"] = rng.uniform(100, 650, (batch, 21)).astype(np.float32)
    return raw


def test_prepare_batch_matches_jax():
    """H and D within 2.5e-7 (two f32 ulps at 1): under jit XLA folds the
    affine maps of normalize and the depth planes into other roundings than
    the eager ops, which test_*_exact hold bit for bit."""
    raw = _raw_batch()
    want = jax_prepare_batch(6.0)(raw)
    got = make_prepare_batch(6.0, device="cpu")(raw)
    assert set(got) == set(want) == {"H1", "P1", "D1", "H2", "P2", "D2"}
    for k in ("H1", "D1", "H2", "D2"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=2.5e-7, err_msg=k)
    for k, uv in (("P1", raw["src_uv"]), ("P2", raw["tgt_uv"])):
        assert got[k].shape == (2, 32, 32, 21)
        assert_heatmaps_close(got[k].numpy(), np.asarray(want[k]), uv, 32, 32)


def test_prepare_batch_prerendered_passes_through():
    rng = np.random.RandomState(6)
    raw = {k: rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
           for k in ("H1", "P1", "D1", "H2", "P2", "D2")}
    got = make_prepare_batch(6.0, device="cpu")(raw)
    want = jax_prepare_batch(6.0)(raw)
    for k in raw:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

