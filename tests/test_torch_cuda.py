"""mmhand_torch's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the other files.)
"""

import numpy as np
import pytest
import torch

from mmhand_torch.data.loader import make_prepare_batch
from mmhand_torch.ops.heatmap import (
    CLIP_LO,
    gaussian_heatmaps,
    gaussian_heatmaps_ref,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _off_clip_boundary(uv, height, width, sigma=6.0):
    """Mask of pixels whose unclipped Gaussian (float64) is more than 1e-6
    from the 0.0099 clip, where a last-bit difference cannot flip it."""
    rows = np.arange(height, dtype=np.float64)[:, None, None]
    cols = np.arange(width, dtype=np.float64)[None, :, None]
    uv = np.asarray(uv, np.float64)
    d2 = ((cols - uv[:, None, None, :, 0]) ** 2
          + (rows - uv[:, None, None, :, 1]) ** 2)
    return np.abs(np.exp(-d2 / (2 * sigma * sigma)) - CLIP_LO) > 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("batch,height,width", [(16, 256, 256), (3, 70, 90)])
def test_heatmap_kernel_matches_plain(cuda, batch, height, width):
    """atol 1e-6: the plain version on CUDA divides by 2 sigma^2 as a
    multiply by its reciprocal, the kernel divides; a last-bit difference
    before exp."""
    uv_np = np.random.RandomState(7).uniform(
        -10, width + 10, (batch, 21, 2)).astype(np.float32)
    uv = torch.from_numpy(uv_np).to(cuda)
    before = gaussian_heatmaps.launches
    got = gaussian_heatmaps(uv, height, width, 6.0)
    torch.cuda.synchronize()
    assert gaussian_heatmaps.launches == before + 1
    assert got.shape == (batch, height, width, 21) and got.is_cuda
    want = gaussian_heatmaps_ref(uv, height, width, 6.0)
    keep = _off_clip_boundary(uv_np, height, width)
    np.testing.assert_allclose(np.where(keep, got.cpu().numpy(), 0),
                               np.where(keep, want.cpu().numpy(), 0),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_heatmap_kernel_checks_its_input(cuda):
    uv = torch.zeros(2, 21, 2, device=cuda)
    with pytest.raises(TypeError):
        gaussian_heatmaps(uv.double())
    with pytest.raises(ValueError):
        gaussian_heatmaps(torch.zeros(2, 21, 3, device=cuda))
    with pytest.raises(ValueError):
        gaussian_heatmaps(uv.transpose(0, 1))


@pytest.mark.cuda
def test_prepare_batch_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(8)
    raw = {}
    for side in ("src", "tgt"):
        raw[f"{side}_image"] = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
        raw[f"{side}_depth"] = rng.randint(0, 700, (2, 32, 32)).astype(np.uint16)
        raw[f"{side}_uv"] = rng.uniform(4, 28, (2, 21, 2)).astype(np.float32)
    got = make_prepare_batch(6.0, cuda)(raw)
    want = make_prepare_batch(6.0, "cpu")(raw)
    # CUDA divides by a Python scalar as a multiply by its reciprocal: 2 ulps
    for k in ("H1", "D1", "H2", "D2"):
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                   rtol=0, atol=2.5e-7, err_msg=k)
    for k, uv in (("P1", raw["src_uv"]), ("P2", raw["tgt_uv"])):
        keep = _off_clip_boundary(uv, 32, 32)
        np.testing.assert_allclose(np.where(keep, got[k].cpu().numpy(), 0),
                                   np.where(keep, want[k].numpy(), 0),
                                   rtol=0, atol=1e-6)
