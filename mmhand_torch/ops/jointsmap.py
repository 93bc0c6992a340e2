"""Depth-ordered bone-ellipse "jointsmap" rasterizer (counterpart of
mmhand_tpu/ops/jointsmap.py).

Reference (reference data/generic_dataset.py:30-78): for each of 20 hand
bones an ellipse around the bone segment (semi-axes (length/2, 5), rotated to
the segment angle) is filled with the bone's average keypoint depth; a
running per-pixel min over bone depths decides occlusion, and the winning
bone's colour value is written (background 0).  The inside test is the exact
analytic ellipse, as in mmhand_tpu; later bones win depth ties.

``generate_jointsmap`` dispatches on where ``uv`` lies: a CPU tensor goes to
the plain version ``generate_jointsmap_ref``, a CUDA tensor to the
hand-written kernel in ``csrc/jointsmap.cu``, built at first use by
``ops._build``.  Both keep mmhand_tpu's operation order, one rounding per
operation, so they agree bit for bit with ``generate_jointsmap`` and
``generate_jointsmap_pallas`` there.  The kernel skips, for each tile of
pixels, the bones that certainly miss it (``culled_tiles``), which leaves
the output as it was.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mmhand_torch.utils import trace

# (joint_a, joint_b), colour value; the order decides depth ties
# (reference generic_dataset.py:33-54).
HAND_BONES = (
    (0, 17), (0, 1), (0, 5), (0, 9), (0, 13),
    (17, 18), (18, 19), (19, 20),
    (1, 2), (2, 3), (3, 4),
    (5, 6), (6, 7), (7, 8),
    (9, 10), (10, 11), (11, 12),
    (13, 14), (14, 15), (15, 16),
)
BONE_COLORS = (
    160, 170, 180, 190, 200,
    130, 140, 150,
    10, 20, 30,
    40, 50, 60,
    70, 80, 90,
    100, 110, 120,
)
BONE_RADIUS = 5.0  # reference generic_dataset.py:70
_BIG = 3.0e38      # initial depth of every pixel
# Margins of the kernel's cull: relative, and absolute in pixels.  They
# cover the roundings of the inside test, which are ~1e-7 relative.
CULL_REL = 1e-3
CULL_PAD = 1.0
# (rows, cols) of the pixel tiles, from (0, 0), for which one warp of the
# kernel culls bones together (kTileRows, kTileCols in csrc/jointsmap.cu).
CULL_TILE = (8, 16)


def bone_params(uv: torch.Tensor, depth: torch.Tensor):
    """Per-bone (mx, my, cos, sin, half_len, avg_depth), each (..., 20),
    from (..., 21, 2) keypoints and (..., 21) depths, in float32."""
    uv = uv.to(torch.float32)
    depth = depth.to(torch.float32)
    a_idx = torch.tensor([b[0] for b in HAND_BONES], device=uv.device)
    b_idx = torch.tensor([b[1] for b in HAND_BONES], device=uv.device)
    p0 = uv[..., a_idx, :]
    p1 = uv[..., b_idx, :]
    mx = (p0[..., 0] + p1[..., 0]) / 2.0
    my = (p0[..., 1] + p1[..., 1]) / 2.0
    dx = p0[..., 0] - p1[..., 0]
    dy = p0[..., 1] - p1[..., 1]
    length = torch.sqrt(dx * dx + dy * dy)
    # unit direction of the bone (the major axis); guard zero length
    safe = torch.maximum(length, torch.tensor(1e-6, device=uv.device))
    cos = dx / safe
    sin = dy / safe
    half_len = torch.maximum(length / 2.0,
                             torch.tensor(1e-3, device=uv.device))
    avg_d = (depth[..., a_idx] + depth[..., b_idx]) / 2.0
    return mx, my, cos, sin, half_len, avg_d


def outside_rectangle(params, cx, cy, hx: float, hy: float) -> torch.Tensor:
    """Where no pixel centre of the box about (cx, cy) with half extents
    (hx, hy) can pass the inside test of the bones ``params`` (from
    ``bone_params``), in float32 as the kernel decides it.

    Inside needs |u| <= half_len and |v| <= BONE_RADIUS.  u and v are affine
    in the pixel, so over the box they stay within hx |cos| + hy |sin| (u)
    and hx |sin| + hy |cos| (v) of their value at its centre.  The rectangle
    is widened by CULL_REL and CULL_PAD for the roundings of the test.
    Nothing assumes (cos, sin) is a unit vector (below length 1e-6 it is
    not), cos = sin = 0 gives u = v = 0, never outside, and a NaN is never
    outside.
    """
    mx, my, cos, sin, half_len, _ = params
    ux, uy = cx - mx, cy - my
    ac, as_ = cos.abs(), sin.abs()
    slack = CULL_REL * (half_len + BONE_RADIUS + (ux.abs() + hx) * ac
                        + (uy.abs() + hy) * as_) + CULL_PAD
    return (((ux * cos + uy * sin).abs()
             > half_len + hx * ac + hy * as_ + slack)
            | ((uy * cos - ux * sin).abs()
               > BONE_RADIUS + hx * as_ + hy * ac + slack))


def culled_tiles(uv: torch.Tensor, depth: torch.Tensor, height: int,
                 width: int) -> torch.Tensor:
    """(..., 20, tiles_y, tiles_x) bool: the (bone, tile) pairs the kernel
    skips, the ``CULL_TILE`` tiles whose pixels the bone's
    ``outside_rectangle`` rules out."""
    params = tuple(p[..., None, None] for p in bone_params(uv, depth))
    th, tw = CULL_TILE
    hx, hy = 0.5 * (tw - 1), 0.5 * (th - 1)
    cy = torch.arange(0, height, th, dtype=torch.float32,
                      device=uv.device)[:, None] + hy
    cx = torch.arange(0, width, tw, dtype=torch.float32, device=uv.device) + hx
    return outside_rectangle(params, cx, cy, hx, hy)


def generate_jointsmap_ref(uv: torch.Tensor, depth: torch.Tensor,
                           height: int = 256, width: int = 256) -> torch.Tensor:
    """Plain PyTorch jointsmap: (..., 21, 2) and (..., 21) -> (..., H, W)
    float32, one bone at a time in the Pallas kernel's order."""
    params = bone_params(uv, depth)
    rows = torch.arange(height, dtype=torch.float32, device=uv.device)[:, None]
    cols = torch.arange(width, dtype=torch.float32, device=uv.device)
    lead = tuple(uv.shape[:-2])
    best = torch.full(lead + (height, width), _BIG, device=uv.device)
    out = torch.zeros(lead + (height, width), device=uv.device)
    for i, color in enumerate(BONE_COLORS):
        mx, my, cos, sin, half_len, avg_d = (p[..., i, None, None]
                                             for p in params)
        dx = cols - mx
        dy = rows - my
        u = dx * cos + dy * sin
        v = -dx * sin + dy * cos
        uh = u / half_len
        vr = v / BONE_RADIUS
        inside = uh * uh + vr * vr <= 1.0
        win = inside & (avg_d <= best)
        best = torch.where(win, avg_d, best)
        out = torch.where(win, float(color), out)
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    from mmhand_torch.ops._build import load_library

    fn = load_library().mmhand_jointsmap
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _generate_jointsmap_cuda(uv: torch.Tensor, depth: torch.Tensor,
                             height: int, width: int) -> torch.Tensor:
    n = len(HAND_BONES) + 1
    if uv.dtype != torch.float32 or depth.dtype != torch.float32:
        raise TypeError(f"generate_jointsmap: uv and depth must be float32, "
                        f"got {uv.dtype} and {depth.dtype}")
    if (uv.dim() < 2 or uv.shape[-2:] != (n, 2)
            or depth.shape != uv.shape[:-1]):
        raise ValueError(f"generate_jointsmap: uv must be (..., {n}, 2) and "
                         f"depth (..., {n}), got {tuple(uv.shape)} and "
                         f"{tuple(depth.shape)}")
    if depth.device != uv.device:
        raise ValueError("generate_jointsmap: uv and depth lie on "
                         f"{uv.device} and {depth.device}")
    if not (uv.is_contiguous() and depth.is_contiguous()):
        raise ValueError("generate_jointsmap: uv and depth must be contiguous")
    lead = tuple(uv.shape[:-2])
    batch = math.prod(lead)
    if batch * height * width >= 2 ** 31 or batch >= 2 ** 16:
        raise ValueError("generate_jointsmap: batch * height * width must "
                         "stay below 2^31 and batch below 2^16")
    out = torch.empty(lead + (height, width), dtype=torch.float32,
                      device=uv.device)
    with torch.cuda.device(uv.device):
        stream = torch.cuda.current_stream(uv.device).cuda_stream
        err = _kernel()(uv.data_ptr(), depth.data_ptr(), out.data_ptr(),
                        batch, height, width, CULL_REL, CULL_PAD, stream)
    if err != 0:
        raise RuntimeError(f"jointsmap kernel launch failed: cudaError {err}")
    trace.count("k3.launches")
    return out


def generate_jointsmap(uv: torch.Tensor, depth: torch.Tensor,
                       height: int = 256, width: int = 256) -> torch.Tensor:
    """Rasterize the coloured-bone jointsmap.

    Args:
      uv: (..., 21, 2) float32 keypoint pixel coordinates (x, y).
      depth: (..., 21) float32 per-keypoint depth, on uv's device.
    Returns:
      (..., H, W) float32 bone colour values (0 = background) on uv's
      device.  On a CUDA device this is the hand-written kernel, and
      the counter ``k3.launches`` of ``utils.trace`` counts its launches.
    """
    if uv.device.type == "cpu":
        return generate_jointsmap_ref(uv, depth, height, width)
    if uv.device.type == "cuda":
        return _generate_jointsmap_cuda(uv, depth, height, width)
    raise ValueError(f"generate_jointsmap: no kernel for device {uv.device}")
