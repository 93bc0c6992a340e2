"""Pose nearest-neighbour search, the pose-diversity tooling (counterpart of
mmhand_tpu/eval/pose_search.py; reference
nearest_neighbor_search/nearest_neighbor_search.py:11-119).

A pose embeds as [centroid (3), palm -> 5 fingertip distances, sqrt(convex
hull area)], on the host with numpy and scipy.  Similarity is the angular
pose distance d = arccos(<du, dv> / |du| |dv|) / pi over the consecutive
joints' difference vectors (:68-88).  The searches are exact scans in
float64 on ``device`` in place of the reference's python kd-tree:
``knn_pose_distance`` under the angular distance, ``knn_embedding``
Euclidean in the 9-D embedding space, the kd-tree's keys.

Ties: both searches sort stably, so among equal distances the lower
database index comes first (mmhand_tpu's ``np.argsort`` leaves their order
unspecified).  Each returns numpy ``(indices, distances)``, ascending.
"""

from __future__ import annotations

import numpy as np
import torch


def pose_embedding(xyz, uv) -> np.ndarray:
    """[centroid (3), 5 palm -> tip distances, sqrt(hull area)]
    (reference :11-58).  xyz: (21, 3); uv: (21, 2)."""
    xyz = np.asarray(xyz, np.float64)
    uv = np.asarray(uv, np.float64)
    centroid = xyz.mean(axis=0)
    palm = xyz[0]
    tips = xyz[[20, 4, 8, 12, 16]]
    tip_d = np.linalg.norm(tips - palm, axis=1)
    area = _convex_hull_area(uv)
    return np.concatenate([centroid, tip_d, [np.sqrt(area)]])


def _convex_hull_area(points_2d) -> float:
    """The hull's area, 0.0 where the points span no area (Qhull raises)."""
    from scipy.spatial import ConvexHull, QhullError

    try:
        return float(ConvexHull(np.asarray(points_2d, np.float64)).volume)
    except QhullError:
        return 0.0


def bone_difference_vectors(xyz) -> np.ndarray:
    """Flattened consecutive-joint differences u_i = x_i - x_{i-1}
    (reference :67-77 'identity'); (..., 21, 3) -> (..., 60)."""
    xyz = np.asarray(xyz, np.float64)
    diff = xyz[..., 1:, :] - xyz[..., :-1, :]
    return diff.reshape(*diff.shape[:-2], 60)


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def _angular(db: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """arccos of the cosine between each row of ``db`` (N, 60) and ``q``
    (60,), over pi.  The dot is a sum over each row, so equal rows give
    equal distances."""
    qn = q / torch.linalg.vector_norm(q)
    dbn = db / torch.linalg.vector_norm(db, dim=1, keepdim=True)
    cos = torch.clamp((dbn * qn).sum(dim=1), -1.0, 1.0)
    return torch.arccos(cos) / np.pi


def _nearest(d: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
    d, idx = torch.sort(d, stable=True)
    return idx[:k].cpu().numpy(), d[:k].cpu().numpy()


def pose_distance(u_xyz, v_xyz, device="cuda") -> float:
    """Angular pose distance of two (21, 3) poses (reference :68-88)."""
    u = _f64(bone_difference_vectors(u_xyz), device)
    v = _f64(bone_difference_vectors(v_xyz), device)
    return float(_angular(u[None], v)[0])


def knn_pose_distance(query_xyz, database_xyz, k: int = 25, device="cuda"):
    """Exact k-NN of a (21, 3) query among (N, 21, 3) poses under the
    angular pose distance -> (indices (k,), distances (k,)), ascending."""
    q = _f64(bone_difference_vectors(query_xyz), device)
    db = _f64(bone_difference_vectors(database_xyz), device)
    return _nearest(_angular(db, q), k)


def knn_embedding(query_emb, database_emb, k: int = 25, device="cuda"):
    """Euclidean k-NN in the 9-D embedding space (the reference kd-tree's
    keys) -> (indices (k,), distances (k,)), ascending."""
    q = _f64(query_emb, device)
    db = _f64(database_emb, device)
    return _nearest(torch.linalg.vector_norm(db - q, dim=1), k)
