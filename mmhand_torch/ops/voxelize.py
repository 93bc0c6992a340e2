"""V2V voxelization and 3-D augmentation of the MSRA depth pipeline
(counterpart of mmhand_tpu/ops/voxelize.py; reference
baselines/quantitative_on_benchmarks/data/msrahand_dataset.py: 34-132
ellipsoid and rotation, 318-492 coordinate warps, scattering and heatmaps,
651-711 V2VVoxelization).

A point cloud is normalized around a reference point, augmented (resize,
rotation about z, translation), scattered into a cropped_size^3 occupancy
cube, and the keypoints become voxel coordinates, a cube of bone capsules or
Gaussian heatmaps.  Every function is float32 torch on the device of its
tensors; ``V2VVoxelization`` draws its augmentation on the host from a numpy
``RandomState`` in the reference's order and rasterizes on its ``device``.

As in mmhand_tpu: ``scattering`` truncates toward zero, so a coordinate in
(-1, 0) lands in voxel 0, and drops out-of-range points through a spare slot
instead of a boolean mask; ``extract_coord_from_output`` takes the first
maximum; the bone capsules are spheres of radius d/2.5 (reference :800),
tested with the general rotated quadric.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

# bone connections (reference msrahand_dataset.py:12-32; the wrist spokes
# are commented out upstream)
CONNECTIONS = np.array([
    [1, 2], [2, 3], [3, 4],
    [5, 6], [6, 7], [7, 8],
    [9, 10], [10, 11], [11, 12],
    [13, 14], [14, 15], [15, 16],
    [17, 18], [18, 19], [19, 20],
], np.int64)
# the capsules' rotation in degrees (reference :800)
BONE_ROTATION = (80.0, 30.0, 20.0)


def _f32(v, device) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v, np.float32))
    return v.to(device=device, dtype=torch.float32)


def build_rotation_matrix(ax, ay, az, inverse: bool = False) -> torch.Tensor:
    """Euler X -> Y -> Z rotation (reference :34-68) of 0-d float32
    tensors."""
    if inverse:
        ax, ay, az = -ax, -ay, -az
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, torch.cos(ax), -torch.sin(ax)]),
                      torch.stack([zero, torch.sin(ax), torch.cos(ax)])])
    ry = torch.stack([torch.stack([torch.cos(ay), zero, torch.sin(ay)]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-torch.sin(ay), zero, torch.cos(ay)])])
    rz = torch.stack([torch.stack([torch.cos(az), -torch.sin(az), zero]),
                      torch.stack([torch.sin(az), torch.cos(az), zero]),
                      torch.stack([zero, zero, one])])
    return rz @ ry @ rx


def ellipsoid_quadric(size: int, centers: torch.Tensor, radii: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """(K, size, size, size) values of the K ellipsoids' quadric
    sum((R (voxel - center) / radii)^2), indexed [x, y, z]; a voxel lies
    inside where it is <= 1.  ``centers`` and ``radii`` are (K, 3), ``angle``
    the (3,) Euler angles the reference negates (:71-132; its axis
    reversals cancel, mmhand_tpu's ``make_ellipsoid_mask``)."""
    device = centers.device
    r = build_rotation_matrix(*(-angle).unbind())
    frac = 0.5 * size - math.floor(0.5 * size)  # 0 for even sizes
    g = torch.arange(size, dtype=torch.float32, device=device)
    # the offset of voxel (x, y, z) along each axis, per ellipsoid
    off = [g.view(1, -1, 1, 1), g.view(1, 1, -1, 1), g.view(1, 1, 1, -1)]
    off = [o - centers[:, a].view(-1, 1, 1, 1) + frac
           for a, o in enumerate(off)]
    n = 0.0
    for d in range(3):
        e = r[d, 0] * off[0] + r[d, 1] * off[1] + r[d, 2] * off[2]
        n = n + (e / radii[:, d].view(-1, 1, 1, 1)) ** 2
    return n


def make_ellipsoid_mask(size: int, center, radii, angle,
                        device="cuda") -> torch.Tensor:
    """Binary (size, size, size) float32 ellipsoid, indexed [x, y, z] like
    the occupancy cube (reference make_ellipsoid_image :71-132)."""
    q = ellipsoid_quadric(size, _f32(center, device).view(1, 3),
                          _f32(radii, device).view(1, 3),
                          _f32(angle, device))
    return (q[0] <= 1.0).float()


def discretize(coord: torch.Tensor, cropped_size: int) -> torch.Tensor:
    """[-1, 1] -> [0, cropped_size] (reference :318-324)."""
    return (coord + 1.0) / (2.0 / cropped_size)


def warp2continuous(coord: torch.Tensor, refpoint, cubic_size: float,
                    cropped_size: int) -> torch.Tensor:
    """Voxel indices -> world mm around ``refpoint`` (reference :327-339)."""
    coord = coord * (2.0 / cropped_size) - 1.0
    return coord * cubic_size / 2.0 + _f32(refpoint, coord.device)


def generate_coord(points: torch.Tensor, refpoint, new_size, angle, trans,
                   sizes) -> torch.Tensor:
    """Normalize and augment (N, 3) points into the cropped volume's voxel
    coordinates (reference :384-428), on ``points``' device.  The
    reference's three resize branches are one formula,
    coord * s + (original / 2) * (1 - s)."""
    cubic_size, cropped_size, original_size = sizes
    device = points.device
    coord = (points.float() - _f32(refpoint, device)) / (cubic_size / 2.0)
    coord = discretize(coord, cropped_size)
    coord = coord + (original_size / 2.0 - cropped_size / 2.0)

    s = _f32(new_size, device) / 100.0
    coord = coord * s + original_size / 2.0 * (1.0 - s)

    # rotation about z around the volume's centre (reference :417-424);
    # angle 0 gives the reference's skipped branch exactly
    angle = _f32(angle, device)
    cos, sin = torch.cos(angle), torch.sin(angle)
    cx = coord[:, 0] - original_size / 2.0
    cy = coord[:, 1] - original_size / 2.0
    rx = cx * cos - cy * sin + original_size / 2.0
    ry = cx * sin + cy * cos + original_size / 2.0
    coord = torch.stack([rx, ry, coord[:, 2]], dim=-1)
    return coord - _f32(trans, device)


def scattering(coord: torch.Tensor, cropped_size: int) -> torch.Tensor:
    """Point coordinates in [0, cropped_size) -> binary float32 occupancy
    cube (reference :341-362).  The cast truncates toward zero; points out
    of range go to a spare slot past the cube, which is dropped."""
    idx = coord.to(torch.int64)
    in_range = ((idx >= 0) & (idx < cropped_size)).all(dim=1)
    flat = (idx[:, 0] * cropped_size + idx[:, 1]) * cropped_size + idx[:, 2]
    volume = cropped_size ** 3
    flat = torch.where(in_range, flat, torch.full_like(flat, volume))
    cube = torch.zeros(volume + 1, dtype=torch.float32, device=coord.device)
    cube[flat] = 1.0
    return cube[:volume].view((cropped_size,) * 3)


def extract_coord_from_output(output: torch.Tensor,
                              center: bool = True) -> torch.Tensor:
    """(..., S, S, S) heatmaps -> (..., 3) argmax voxel coordinates, the
    first maximum where several tie (reference :362-382)."""
    vsize = output.shape[-3:]
    max_index = output.reshape(*output.shape[:-3], -1).argmax(dim=-1)
    i0 = max_index // (vsize[1] * vsize[2])
    i1 = (max_index // vsize[2]) % vsize[1]
    i2 = max_index % vsize[2]
    xyz = torch.stack([i0, i1, i2], dim=-1).float()
    return xyz + 0.5 if center else xyz


def generate_cubic_input(points, refpoint, new_size, angle, trans,
                         sizes) -> torch.Tensor:
    """Point cloud -> occupancy cube (reference :430-437)."""
    coord = generate_coord(points, refpoint, new_size, angle, trans, sizes)
    return scattering(coord, sizes[1])


def generate_cubic_hand(keypoints, refpoint, new_size, angle, trans,
                        sizes) -> torch.Tensor:
    """Keypoints -> their voxels and the 15 bones' capsules, one binary cube
    (reference :440-468: radii [d/2.5]*3, rotation (80, 30, 20) degrees),
    the bones as one broadcast over a leading axis of 15."""
    cropped_size = sizes[1]
    coord = generate_coord(keypoints, refpoint, new_size, angle, trans, sizes)
    cubic = scattering(coord, cropped_size)
    rot = torch.deg2rad(torch.tensor(BONE_ROTATION, device=coord.device))
    j1 = coord[torch.as_tensor(CONNECTIONS[:, 0], device=coord.device)]
    j2 = coord[torch.as_tensor(CONNECTIONS[:, 1], device=coord.device)]
    d = torch.sqrt(((j1 - j2) ** 2).sum(dim=1))
    centers = (j1 - j2).abs() / 2.0 + torch.minimum(j1, j2)
    radii = (d / 2.5).unsqueeze(1).expand(-1, 3)
    inside = ellipsoid_quadric(cropped_size, centers, radii, rot) <= 1.0
    return ((cubic + inside.float().sum(dim=0)) >= 1.0).float()


def generate_heatmap_gt(keypoints, refpoint, new_size, angle, trans, sizes,
                        pool_factor: int = 2, std: float = 1.7
                        ) -> torch.Tensor:
    """Keypoints -> (K, S/pf, S/pf, S/pf) Gaussian heatmaps
    (reference :471-492)."""
    cropped_size = sizes[1]
    coord = generate_coord(keypoints, refpoint, new_size, angle, trans,
                           sizes) / pool_factor
    out = cropped_size // pool_factor
    g = torch.arange(out, dtype=torch.float32, device=coord.device) + 0.5
    dx = (g.view(1, -1, 1, 1) - coord[:, 0].view(-1, 1, 1, 1)) / std
    dy = (g.view(1, 1, -1, 1) - coord[:, 1].view(-1, 1, 1, 1)) / std
    dz = (g.view(1, 1, 1, -1) - coord[:, 2].view(-1, 1, 1, 1)) / std
    return torch.exp(-(dx ** 2 + dy ** 2 + dz ** 2) / 2.0)


class V2VVoxelization:
    """The sample transform (reference :651-711): the augmentation's draws
    are the reference's ``np.random`` calls, in its order, from ``rng``;
    the rasterization runs on ``device``."""

    def __init__(self, cubic_size: float, augmentation: bool = True,
                 rng: Optional[np.random.RandomState] = None,
                 device="cuda"):
        self.cubic_size = cubic_size
        self.cropped_size, self.original_size = 64, 96
        self.sizes = (self.cubic_size, self.cropped_size, self.original_size)
        self.pool_factor = 2
        self.std = 1.7
        self.augmentation = augmentation
        self.rng = rng if rng is not None else np.random.RandomState()
        self.device = torch.device(device)

    def _draws(self):
        if not self.augmentation:
            return 100.0, 0.0, np.full(
                (3,), self.original_size / 2 - self.cropped_size / 2)
        new_size = self.rng.rand() * 40 + 80
        angle = self.rng.rand() * 80 / 180 * np.pi - 40 / 180 * np.pi
        trans = self.rng.rand(3) * (self.original_size - self.cropped_size)
        return new_size, angle, trans

    def __call__(self, sample: dict):
        """{points (N, 3), keypoints (K, 3), refpoint (3,)} -> the input
        cube (1, S, S, S), the keypoints' voxel coordinates (K, 3) and the
        hand cube (1, S, S, S), on ``device``."""
        points = _f32(sample["points"], self.device)
        keypoints = _f32(sample["keypoints"], self.device)
        refpoint = sample["refpoint"]
        new_size, angle, trans = self._draws()
        inp = generate_cubic_input(points, refpoint, new_size, angle, trans,
                                   self.sizes)
        hand = generate_cubic_hand(keypoints, refpoint, new_size, angle,
                                   trans, self.sizes)
        coords = generate_coord(keypoints, refpoint, new_size, angle, trans,
                                self.sizes)
        return inp[None], coords, hand[None]

    def _centred(self):
        return np.full((3,), self.original_size / 2 - self.cropped_size / 2)

    def voxelize(self, points, refpoint) -> torch.Tensor:
        return generate_cubic_input(_f32(points, self.device), refpoint,
                                    100.0, 0.0, self._centred(),
                                    self.sizes)[None]

    def generate_heatmap(self, keypoints, refpoint) -> torch.Tensor:
        return generate_heatmap_gt(_f32(keypoints, self.device), refpoint,
                                   100.0, 0.0, self._centred(), self.sizes,
                                   self.pool_factor, self.std)

    def evaluate(self, heatmaps, refpoints) -> torch.Tensor:
        """Heatmaps -> world mm of their maxima (reference :704-711)."""
        if not isinstance(heatmaps, torch.Tensor):
            heatmaps = torch.from_numpy(np.array(heatmaps))
        coords = extract_coord_from_output(
            heatmaps.to(self.device)) * self.pool_factor
        return warp2continuous(coords, refpoints, self.cubic_size,
                               self.cropped_size)
