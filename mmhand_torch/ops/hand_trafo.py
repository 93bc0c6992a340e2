"""Canonical and relative hand-pose coordinate transforms of the hand3d
stack (counterpart of mmhand_tpu/ops/hand_trafo.py; reference
hand_pose_estimators/CVPR2020_hand3d/utils/canonical_trafo.py:21-163,
utils/relative_trafo.py:18-294).

* ``canonical_trafo``: root keypoint at the origin, the middle finger's
  metacarpal (keypoint 12) on the -y axis, the pinky (keypoint 20) fixing
  the rotation about y; the frame in which hand3d's PosePrior predicts.
* ``flip_right_hand``: the right hand mirrored in z.
* ``bone_rel_trafo`` and its inverse: (length, angle_x, angle_y) per bone
  along the kinematic chain.

Kept as the reference has them: its ``atan2`` adds 1e-8 to x before the
division (its TF1 had no native atan2), and the homogeneous x-rotation of
the relative trafo has the opposite sign convention to the canonical one.
"""

from __future__ import annotations

import torch

PI = 3.141592653589793

# parent of each keypoint (-1: anchored at the root), walked root to leaf
# (reference relative_trafo.py:146-182)
KINEMATIC_PARENT = {0: -1,
                    4: -1, 3: 4, 2: 3, 1: 2,
                    8: -1, 7: 8, 6: 7, 5: 6,
                    12: -1, 11: 12, 10: 11, 9: 10,
                    16: -1, 15: 16, 14: 15, 13: 14,
                    20: -1, 19: 20, 18: 19, 17: 18}
KINEMATIC_ORDER = [0, 4, 3, 2, 1, 8, 7, 6, 5, 12, 11, 10, 9,
                   16, 15, 14, 13, 20, 19, 18, 17]


def _chain_levels() -> list:
    """KINEMATIC_ORDER by depth in the chain: every bone's parent lies in
    the level before, so the bones of one level are taken together."""
    depth = {}
    for bone in KINEMATIC_ORDER:
        parent = KINEMATIC_PARENT[bone]
        depth[bone] = 0 if parent == -1 else depth[parent] + 1
    return [[b for b in KINEMATIC_ORDER if depth[b] == d]
            for d in range(max(depth.values()) + 1)]


CHAIN_LEVELS = _chain_levels()


def atan2_ref(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference's atan2 built from atan (canonical_trafo.py:21-38),
    with its +1e-8 in the denominator."""
    tan = torch.atan(y / (x + 1e-8))
    tan = tan + torch.where(x + 1e-8 < 0.0, PI, 0.0)
    tan = tan + torch.where(tan < 0.0, 2 * PI, 0.0)
    return tan + torch.where(tan > PI, -2 * PI, 0.0)


def _mat(entries: list, angle: torch.Tensor, n: int) -> torch.Tensor:
    """(...,) angle and n*n entries of its shape -> (..., n, n)."""
    return torch.stack(entries, -1).reshape(*angle.shape, n, n)


def _rot_x(angle):
    """(B,) -> (B, 3, 3) (reference canonical_trafo.py:65-72)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    return _mat([o, z, z, z, c, s, z, -s, c], angle, 3)


def _rot_y(angle):
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    return _mat([c, z, -s, z, o, z, s, z, c], angle, 3)


def _rot_z(angle):
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    return _mat([c, s, z, -s, c, z, z, z, o], angle, 3)


def canonical_trafo(coords_xyz: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 21, 3) -> (canonical coords, the whole rotation (B, 3, 3))
    (reference canonical_trafo.py:96-138)."""
    coords_xyz = coords_xyz.reshape(-1, 21, 3)
    root, align, rot_kp = 0, 12, 20

    coords_t = coords_xyz - coords_xyz[:, root:root + 1, :]

    p = coords_t[:, align, :]
    rot = _rot_z(atan2_ref(p[:, 0], p[:, 1]))
    coords_r1 = coords_t @ rot
    total = rot

    p = coords_r1[:, align, :]
    beta = -atan2_ref(p[:, 2], p[:, 1])
    rot = _rot_x(beta + PI)
    coords_r2 = coords_r1 @ rot
    total = total @ rot

    p = coords_r2[:, rot_kp, :]
    rot = _rot_y(atan2_ref(p[:, 2], p[:, 0]))
    return coords_r2 @ rot, total @ rot


def flip_right_hand(coords_xyz_canonical: torch.Tensor,
                    cond_right) -> torch.Tensor:
    """Mirror z where ``cond_right`` (reference canonical_trafo.py:141-163);
    coords (N, 3) or (B, N, 3), the condition one per sample (or any shape
    of as many elements)."""
    coords = coords_xyz_canonical
    expanded = coords.dim() == 2
    if expanded:
        coords = coords[None]
    cond = torch.as_tensor(cond_right, device=coords.device)
    mirrored = torch.stack(
        [coords[:, :, 0], coords[:, :, 1], -coords[:, :, 2]], -1)
    out = torch.where(cond.reshape(-1, 1, 1), mirrored, coords)
    return out[0] if expanded else out


def _hom_rot_x(angle):
    """(...,) -> (..., 4, 4) homogeneous (reference relative_trafo.py:49-57),
    with the opposite sign convention to ``_rot_x``."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    return _mat([o, z, z, z,
                 z, c, -s, z,
                 z, s, c, z,
                 z, z, z, o], angle, 4)


def _hom_rot_y(angle):
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(angle), torch.zeros_like(angle)
    return _mat([c, z, s, z,
                 z, o, z, z,
                 -s, z, c, z,
                 z, z, z, o], angle, 4)


def _hom_trans_z(trans):
    """Translation along z in homogeneous coordinates (reference :81-89)."""
    o, z = torch.ones_like(trans), torch.zeros_like(trans)
    return _mat([o, z, z, z,
                 z, o, z, z,
                 z, z, o, trans,
                 z, z, z, o], trans, 4)


def _backward(delta_xyz, t):
    """Bone vectors (..., 3) and their global-to-local trafos (..., 4, 4)
    -> (length, angle_x, angle_y, the next trafos) (reference :123-147)."""
    length = torch.sqrt(torch.sum(delta_xyz ** 2, dim=-1))
    angle_y = atan2_ref(delta_xyz[..., 0], delta_xyz[..., 2])
    hom = torch.cat([delta_xyz, torch.ones_like(delta_xyz[..., :1])],
                    -1)[..., None]
    tmp = _hom_rot_y(-angle_y) @ hom
    angle_x = atan2_ref(-tmp[..., 1, 0], tmp[..., 2, 0])
    t_this = _hom_trans_z(-length) @ (_hom_rot_x(-angle_x)
                                      @ _hom_rot_y(-angle_y))
    return length, angle_x, angle_y, t_this @ t


def _forward(length, angle_x, angle_y, t):
    """(length, angles) (...,) -> the bones' global endpoints (..., 3) and
    the next trafos (reference :107-120)."""
    t_this = _hom_trans_z(-length) @ (_hom_rot_x(-angle_x)
                                      @ _hom_rot_y(-angle_y))
    t = t_this @ t
    x0 = torch.zeros((*length.shape, 4, 1), dtype=t.dtype, device=t.device)
    x0[..., 3, 0] = 1.0
    x = torch.linalg.inv(t) @ x0
    return x[..., :3, 0], t


def _parent_trafos(trafos: dict, level: list, eye: torch.Tensor):
    """(B, len(level), 4, 4): each bone's parent trafo, the identity for a
    bone anchored at the root."""
    return torch.stack([eye if KINEMATIC_PARENT[bone] == -1
                        else trafos[KINEMATIC_PARENT[bone]]
                        for bone in level], 1)


def bone_rel_trafo(coords_xyz: torch.Tensor) -> torch.Tensor:
    """(B, 21, 3) xyz -> (B, 21, 3) [length, angle_x, angle_y] per bone
    along the kinematic chain (reference relative_trafo.py:184-241), the
    bones of one chain level at a time."""
    coords_xyz = coords_xyz.reshape(-1, 21, 3)
    b = coords_xyz.shape[0]
    eye = torch.eye(4, dtype=coords_xyz.dtype,
                    device=coords_xyz.device).expand(b, 4, 4)
    hom = torch.cat([coords_xyz, torch.ones_like(coords_xyz[:, :, :1])],
                    2)[..., None]                               # (B, 21, 4, 1)
    trafos, rel = {}, [None] * 21
    for level in CHAIN_LEVELS:
        t = _parent_trafos(trafos, level, eye)
        if all(KINEMATIC_PARENT[bone] == -1 for bone in level):
            delta = coords_xyz[:, level]
        else:
            parents = [KINEMATIC_PARENT[bone] for bone in level]
            delta = (t @ hom[:, level] - t @ hom[:, parents])[..., :3, 0]
        length, ax, ay, t_new = _backward(delta, t)
        out = torch.stack([length, ax, ay], -1)
        for i, bone in enumerate(level):
            rel[bone], trafos[bone] = out[:, i], t_new[:, i]
    return torch.stack(rel, 1)


def bone_rel_trafo_inv(coords_rel: torch.Tensor) -> torch.Tensor:
    """The inverse: (B, 21, 3) [length, angle_x, angle_y] -> xyz
    (reference relative_trafo.py:244-294)."""
    if coords_rel.dim() == 2:
        coords_rel = coords_rel[None]
    b = coords_rel.shape[0]
    eye = torch.eye(4, dtype=coords_rel.dtype,
                    device=coords_rel.device).expand(b, 4, 4)
    trafos, xyz = {}, [None] * 21
    for level in CHAIN_LEVELS:
        rel = coords_rel[:, level]
        x, t_new = _forward(rel[..., 0], rel[..., 1], rel[..., 2],
                            _parent_trafos(trafos, level, eye))
        for i, bone in enumerate(level):
            xyz[bone], trafos[bone] = x[:, i], t_new[:, i]
    return torch.stack(xyz, 1)
