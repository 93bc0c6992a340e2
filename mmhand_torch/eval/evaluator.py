"""One-stop metric engine: IS + FID + SSIM + pose-consistency PCK
(counterpart of mmhand_tpu/eval/evaluator.py; reference
baselines/quantitative_on_benchmarks/utils.py:12-139 and
hpe_estimator.py:97-160).

Each batch is scored on the device as it comes: the Inception forward of the
fakes (and of the real images, for FID), the per-image SSIM and the CPM
judge's keypoint decode; only logits, pool features, SSIM values and
keypoints go to the host.  The forwards run in float32 with TF32 off
(``full_fp32``), the precision at which mmhand_tpu computes FID and PCK.

Output contract (reference utils.py:63-75): {IS_avg, IS_std, SSIM_avg,
SSIM_std, pck2d_auc, pck3d_auc}, plus 'fid' and the 'weights' provenance.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Optional

import numpy as np
import torch

from mmhand_torch.eval.metrics import (
    EvalUtil,
    fid_from_features,
    inception_score_from_logits,
)
from mmhand_torch.models.cpm import Hpm2d, Hpm3d
from mmhand_torch.models.inception import (
    Inception3,
    inception_preprocess,
    init_fan_in,
)
from mmhand_torch.ops.jointsmap import generate_jointsmap
from mmhand_torch.ops.ssim import ssim


@contextlib.contextmanager
def full_fp32():
    """Inference in float32: cuDNN convolutions (TF32 by default on the card)
    and matmuls in full f32, inside the block only."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _place(net: torch.nn.Module, device) -> torch.nn.Module:
    return net.to(device=device, memory_format=torch.channels_last).eval()


class HPEJudge:
    """Frozen CPM 2D + 3D judge feeding EvalUtil
    (reference hpe_estimator.py:97-160)."""

    def __init__(self, hpm2d: Hpm2d, hpm3d: Hpm3d, num_joints: int = 21,
                 device="cuda", random_weights: bool = False):
        self.hpm2d = _place(hpm2d, device)
        self.hpm3d = _place(hpm3d, device)
        self.random_weights = random_weights
        self.eval2d = EvalUtil(num_joints)
        self.eval3d = EvalUtil(num_joints)

    @classmethod
    def random_init(cls, size: int = 256, num_joints: int = 21,
                    device="cuda") -> "HPEJudge":
        """A judge with random weights, drawn on the CPU from seed 0: it
        runs the whole pipeline where no converted CPM weights exist."""
        warnings.warn(
            "HPEJudge running with RANDOM CPM weights: pck2d_auc/pck3d_auc "
            "are structural pipeline checks, NOT comparable metrics "
            "(pass --hpm2d_npz/--hpm3d_npz converted weights for real "
            "numbers)", stacklevel=2)
        gen = torch.Generator().manual_seed(0)
        hpm2d = init_fan_in(Hpm2d(num_joints), gen)
        hpm3d = init_fan_in(Hpm3d(num_joints, size), gen)
        return cls(hpm2d, hpm3d, num_joints, device, random_weights=True)

    def predict(self, images: torch.Tensor):
        """(B, H, W, 3) images in [-1, 1] -> x, y, z of each keypoint, each
        (B, 21) float32 on the device: the argmax of the last stage's
        heatmaps, decoded as mmhand_tpu does (y = idx // H, x = idx % W,
        reference hpe_estimator.py:131), and the 3D net's z times H."""
        with full_fp32():
            heat = self.hpm2d(images)[-1]                    # (B, H, W, 21)
            z = self.hpm3d(heat)                              # (B, 21)
            b, h, w, k = heat.shape
            idx = heat.permute(0, 3, 1, 2).reshape(b, k, -1).argmax(-1)
            y = torch.div(idx, h, rounding_mode="floor").float()
            x = (idx % w).float()
            return x, y, z * h

    def feed(self, images: torch.Tensor, gt_xyz) -> None:
        """images: (B, H, W, 3) in [-1, 1]; gt_xyz: (B, 21, 3) on the host
        with real depth in the z column (scaled to pixels here, reference
        hpe_estimator.py:112-137)."""
        x, y, z = (t.cpu().numpy() for t in self.predict(images))
        gt = np.asarray(gt_xyz, np.float64).copy()
        gt[..., -1] = gt[..., -1] / 700.0 * 256.0
        for b in range(gt.shape[0]):
            p2d = np.stack([x[b], y[b]], axis=-1)
            p3d = np.concatenate([p2d, z[b][:, None]], axis=-1)
            vis = np.ones(gt.shape[1])
            self.eval2d.feed(gt[b, :, :2], vis, p2d)
            self.eval3d.feed(gt[b], vis, p3d)

    def get_results(self, pixel_offset: float = 30.0, n_steps: int = 20):
        return (self.eval2d.get_measures(0, pixel_offset, n_steps),
                self.eval3d.get_measures(0, pixel_offset, n_steps))


class Evaluator:
    """Feeds batches of (generated, ground-truth) images; produces the
    reference score dict + FID."""

    def __init__(self, inception: Optional[Inception3] = None,
                 judge: Optional[HPEJudge] = None, compute_fid: bool = True,
                 ssim_quirk: bool = False, device="cuda"):
        self.random_inception = inception is None
        if inception is None:
            warnings.warn(
                "Evaluator running with RANDOM Inception-v3 weights: "
                "IS/FID are structural pipeline checks, NOT comparable "
                "metrics (pass --inception_npz converted weights for real "
                "numbers)", stacklevel=2)
            inception = init_fan_in(Inception3(),
                                    torch.Generator().manual_seed(0))
        self.inception = _place(inception, device)
        self.judge = judge
        self.compute_fid = compute_fid
        self.ssim_quirk = ssim_quirk
        self._logits_fake: list = []
        self._pool_fake: list = []
        self._pool_real: list = []
        self._ssim: list = []

    @staticmethod
    def create_input_image(xyz: torch.Tensor, size: int = 256) -> torch.Tensor:
        """The conditioning image from xyz alone (reference utils.py:113-125
        _create_input_image): the depth-coloured bone jointsmap (kernel K3 on
        a CUDA device), min-max normalized to [0, 1] per image, repeated to 3
        channels.

        Args:
          xyz: (B, 21, 3) or (21, 3) float32 tensor; z in the reference's
            pixel-ish scale (pass raw_z/700*255 for crop-tree data).
        Returns:
          (B, size, size, 3) float32 in [0, 1] on xyz's device.
        """
        xyz = xyz.to(torch.float32)
        if xyz.dim() == 2:
            xyz = xyz[None]
        jm = generate_jointsmap(xyz[..., :2].contiguous(),
                                xyz[..., 2].contiguous(), size, size)
        lo = jm.amin(dim=(1, 2), keepdim=True)
        hi = jm.amax(dim=(1, 2), keepdim=True)
        jm = (jm - lo) / torch.clamp(hi - lo, min=1e-6)
        return jm[..., None].expand(-1, -1, -1, 3).contiguous()

    def inception_forward(self, images_m11: torch.Tensor):
        """(logits, pool) of [-1, 1] NHWC images, float32 on the device."""
        with full_fp32():
            return self.inception(inception_preprocess(images_m11))

    def ssim_forward(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """Per-image SSIM on [0, 1]-mapped images.  The reference compares
        pred in [-1, 1] against gt in [0, 1], a range-mismatch quirk
        (reference utils.py:100-111) that ``ssim_quirk`` reproduces for 1:1
        comparisons with runs of the reference harness."""
        with full_fp32():
            if self.ssim_quirk:
                return ssim(pred, (gt + 1) / 2, size_average=False)
            return ssim((pred + 1) / 2, (gt + 1) / 2, size_average=False)

    def feed(self, pred_images: torch.Tensor, gt_images: torch.Tensor,
             gt_xyz=None) -> None:
        """pred/gt: (B, H, W, 3) in [-1, 1] on the evaluator's device;
        gt_xyz: optional (B, 21, 3) host array for the judge."""
        logits, pool = self.inception_forward(pred_images)
        self._logits_fake.append(logits.cpu().numpy())
        self._pool_fake.append(pool.cpu().numpy())
        if self.compute_fid:
            self._pool_real.append(
                self.inception_forward(gt_images)[1].cpu().numpy())
        self._ssim.extend(self.ssim_forward(pred_images, gt_images).tolist())
        if self.judge is not None and gt_xyz is not None:
            self.judge.feed(pred_images, gt_xyz)

    def evaluate(self, is_chunk: int = 64) -> dict:
        """Score dict (reference utils.py:63-75 contract + 'fid').

        IS is computed in chunks of ``is_chunk`` images with one split per
        chunk, mean/std across chunks, as the reference's cache-64 scheme
        (utils.py:81-98)."""
        logits = np.concatenate(self._logits_fake, axis=0)
        chunk_scores = [inception_score_from_logits(logits[i:i + is_chunk], 1)[0]
                        for i in range(0, len(logits), is_chunk)]
        scores = {
            "IS_avg": float(np.mean(chunk_scores)),
            "IS_std": float(np.std(chunk_scores)),
            "SSIM_avg": float(np.mean(self._ssim)),
            "SSIM_std": float(np.std(self._ssim)),
        }
        if self.judge is not None:
            r2d, r3d = self.judge.get_results(30, 20)
            scores["pck2d_auc"] = r2d[2]
            scores["pck3d_auc"] = r3d[2]
        if self.compute_fid and self._pool_real:
            scores["fid"] = fid_from_features(
                np.concatenate(self._pool_real, 0),
                np.concatenate(self._pool_fake, 0))
        random_bits = []
        if self.random_inception:
            random_bits.append("inception")
        if self.judge is not None and self.judge.random_weights:
            random_bits.append("cpm")
        scores["weights"] = (
            "random:" + "+".join(random_bits) if random_bits else "loaded")
        return scores

    def clean(self) -> None:
        self._logits_fake.clear()
        self._pool_fake.clear()
        self._pool_real.clear()
        self._ssim.clear()
