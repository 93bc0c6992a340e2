"""Evaluation metrics: EPE/PCK/AUC accumulation, Inception Score, FID
(the port's own copy of mmhand_tpu/eval/metrics.py, numpy and scipy only).

EvalUtil is a faithful port of the reference's accumulator
(reference baselines/quantitative_on_benchmarks/hpe_estimator.py:7-95, same
class in hand_pose_estimators/CVPR2020_hpm3d/models/hpm_model.py:202-301):
per-keypoint euclidean distances, PCK curve over linspace thresholds,
trapezoid AUC normalized by the threshold span.

Inception Score follows reference utils.py:196-232 (exp of mean KL to the
marginal, over splits).  FID is the standard Fréchet distance between
Gaussian fits of pool features — absent from the reference, required by the
north star (BASELINE.md).
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy import linalg


class EvalUtil:
    """Accumulates keypoint errors; mirrors reference feed/get_measures."""

    def __init__(self, num_kp: int = 21):
        self.num_kp = num_kp
        self.data = [[] for _ in range(num_kp)]

    def feed(self, keypoint_gt, keypoint_vis, keypoint_pred):
        gt = np.squeeze(np.asarray(keypoint_gt, np.float64))
        pred = np.squeeze(np.asarray(keypoint_pred, np.float64))
        vis = np.squeeze(np.asarray(keypoint_vis)).astype(bool)
        assert gt.ndim == 2 and pred.ndim == 2 and vis.ndim == 1
        dist = np.sqrt(np.sum((gt - pred) ** 2, axis=1))
        for i in range(gt.shape[0]):
            if vis[i]:
                self.data[i].append(dist[i])

    def _get_pck(self, kp_id: int, threshold: float):
        if not self.data[kp_id]:
            return None
        return float(np.mean(np.asarray(self.data[kp_id]) <= threshold))

    def _get_epe(self, kp_id: int):
        if not self.data[kp_id]:
            return None, None
        d = np.asarray(self.data[kp_id])
        return float(np.mean(d)), float(np.median(d))

    def get_measures(self, val_min: float, val_max: float, steps: int):
        """-> (epe_mean, epe_median, auc, pck_curve, thresholds)."""
        thresholds = np.linspace(val_min, val_max, steps)
        norm_factor = np.trapezoid(np.ones_like(thresholds), thresholds)
        epe_mean_all, epe_median_all, auc_all, pck_curves = [], [], [], []
        for kp in range(self.num_kp):
            mean, median = self._get_epe(kp)
            if mean is None:
                continue
            epe_mean_all.append(mean)
            epe_median_all.append(median)
            curve = np.asarray([self._get_pck(kp, t) for t in thresholds])
            pck_curves.append(curve)
            auc_all.append(np.trapezoid(curve, thresholds) / norm_factor)
        return (float(np.mean(epe_mean_all)), float(np.mean(epe_median_all)),
                float(np.mean(auc_all)), np.mean(np.asarray(pck_curves), 0),
                thresholds)


def inception_score_from_logits(logits, splits: int = 1):
    """IS = exp(mean KL(p(y|x) || p(y))) per split
    (reference utils.py:196-232; tool/inception_score.py:24-96).

    Args:
      logits: (N, 1000) inception logits.
    Returns:
      (mean, std) over splits.
    """
    logits = np.asarray(logits, np.float64)
    x = logits - logits.max(axis=1, keepdims=True)
    e = np.exp(x)
    preds = e / e.sum(axis=1, keepdims=True)
    n = preds.shape[0]
    scores = []
    for k in range(splits):
        part = preds[k * (n // splits):(k + 1) * (n // splits)]
        py = part.mean(axis=0)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def fid_from_features(feat_real, feat_fake, eps: float = 1e-6) -> float:
    """Fréchet Inception Distance between two pool-feature sets.

    ||mu_r - mu_f||^2 + Tr(S_r + S_f - 2 (S_r S_f)^{1/2}).

    With fewer samples than feature dims (<2048 for Inception-v3 pool3) the
    covariances are rank-deficient and sqrtm is numerically unstable: the
    eps ridge is applied PRE-emptively in that regime (and a warning
    emitted) rather than only after a non-finite result — silently degraded
    small-sample FIDs were a round-1 weak spot.
    """
    f1 = np.asarray(feat_real, np.float64)
    f2 = np.asarray(feat_fake, np.float64)
    mu1, mu2 = f1.mean(0), f2.mean(0)
    s1 = np.cov(f1, rowvar=False)
    s2 = np.cov(f2, rowvar=False)
    diff = mu1 - mu2
    d = s1.shape[0]
    if min(f1.shape[0], f2.shape[0]) <= d:
        warnings.warn(
            f"FID from {f1.shape[0]} real / {f2.shape[0]} fake samples with "
            f"{d}-dim features: covariance is singular; applying eps ridge. "
            "Use >2048 samples for a publication-grade FID.", stacklevel=2)
        offset = np.eye(d) * eps
        s1 = s1 + offset
        s2 = s2 + offset
    covmean = linalg.sqrtm(s1 @ s2)
    if not np.isfinite(covmean).all():
        offset = np.eye(d) * eps
        covmean = linalg.sqrtm((s1 + offset) @ (s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2.0 * np.trace(covmean))
