"""The plain reference of ColorHandPose3D's PoseNet training (Zimmermann &
Brox, "Learning to Estimate 3D Hand Pose from Single RGB Images", ICCV
2017; github.com/lmb-freiburg/hand3d, which mm-hand vendors as
hand_pose_estimators/CVPR2020_hand3d): ``nets/ColorHandPose3DNetwork.py``
``inference_pose2d``, ``training_posenet.py`` and the posenet flags of
``data/BinaryDbReader.py``.

* The records: the packed GAN DB of ``data/create_GAN_DB.py``, read here
  with a parser of its own: 42 x 3 float32 xyz, 42 x 2 float32 uv, a 3 x 3
  float32 K, two sentinel bytes 255, the H x W x 3 uint8 image, the H x W
  uint8 mask, 42 uint8 visibilities.
* The batch (``BinaryDbReader`` with use_wrist_coord off, coord_uv_noise
  on at sigma 2.5, no crop, sigma 25): each hand's wrist replaced by its
  palm, mean(kp 0, kp 12), visible if either is; uv plus the noise; the
  image scaled to [-0.5, 0.5]; the hand side from the mask (left if it has
  more left-hand pixels, labels 2-17, than right-hand ones, 18 and up);
  that hand's 21 keypoints and visibilities; scoremaps exp(-d^2 / sigma^2)
  around the keypoints truncated to integers, zero for one invisible or
  not strictly inside (0, size - 1).
* PoseNet2D: 3x3 convs in blocks of 2, 2, 4, 2 (64, 128, 256, 512
  channels) with a 2x2 max-pool after each of the first three, conv4_3 to
  conv4_6 (256), conv4_7 (128): the encoding; conv5_1 (1x1, 512) and
  conv5_2 (1x1, 21): the first scoremap; two recurrent stages over
  cat(scoremap, encoding), each five 7x7 convs and a 1x1 of 128 and a 1x1
  to 21.  Every conv but those that give a scoremap is followed by a leaky
  ReLU max(x, 0.01 x).  TF "SAME" padding: at stride 1 and an odd kernel k,
  (k - 1) / 2 on every side.
* The loss: each stage's scoremaps resized to the ground truth's size by
  TF1's bilinear resize (source = destination x in / out, no half-pixel
  offset, the last pixel repeated), then sum(vis x sqrt(mean over H, W of
  the squared error)) / (sum(vis) + 0.001), summed over the stages.
* Adam (betas 0.9, 0.999, eps 1e-8) at the staged rate (1e-4, 1e-5, 1e-6
  from steps 10,000 and 20,000).

Departures from the published description:
* The noise: TF draws the truncated normal by rejection.  Here the
  uniforms that the measured program's generator drew are an input, as the
  weights are, and become the same law by the inverse normal CDF (a
  standard normal truncated at 2 standard deviations, times 2.5), computed
  in float32 on the CPU.
* The hand side of a record whose mask has no hand pixel (the packed GAN
  DB writes a mask of ones): the published rule takes the right hand, whose
  rows that DB leaves as zero padding, so that every keypoint is invisible
  and the loss 0.  Here such a record takes the hand with more visible
  keypoints, the left on a tie.
* The weights are given (``gan.load_weights``, keyed
  ``posenet.<parameter>``); the published init is xavier-uniform with
  biases 1e-4.

Float32 throughout, with TF32 off (``layers.exact_f32``); the convs are
``layers.QConv2d`` so the control can run it in float8.  Parameters are
named ``<TF scope>.weight`` (OIHW) and ``<TF scope>.bias``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import QConv2d, adam_step

NUM_KP = 21
SIGMA = 25.0
UV_NOISE_SIGMA = 2.5
LR_VALUES = (1e-4, 1e-5, 1e-6)
LR_STEPS = (10_000, 20_000)
BETAS = (0.9, 0.999)
EPS = 1e-8
N_KP = 42


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, 0.01 * x)


def _encoder_plan() -> list:
    """(scope, in, out, kernel) or "pool", in order, to the encoding."""
    plan, width = [], 3
    for block, (n, out, pool) in enumerate(
            zip((2, 2, 4, 2), (64, 128, 256, 512), (1, 1, 1, 0)), 1):
        for layer in range(1, n + 1):
            plan.append((f"conv{block}_{layer}", width, out, 3))
            width = out
        if pool:
            plan.append("pool")
    for i in range(3, 7):
        plan.append((f"conv4_{i}", width, 256, 3))
        width = 256
    plan.append(("conv4_7", 256, 128, 3))
    return plan


class PoseNet2D(nn.Module):
    def __init__(self, num_kp: int = NUM_KP):
        super().__init__()
        self.plan = _encoder_plan()
        convs = [p for p in self.plan if p != "pool"]
        convs += [("conv5_1", 128, 512, 1), ("conv5_2", 512, num_kp, 1)]
        for stage in (6, 7):
            width = num_kp + 128
            for rec in range(1, 6):
                convs.append((f"conv{stage}_{rec}", width, 128, 7))
                width = 128
            convs += [(f"conv{stage}_6", 128, 128, 1),
                      (f"conv{stage}_7", 128, num_kp, 1)]
        for name, cin, cout, k in convs:
            # TF "SAME" at stride 1, odd k: (k - 1) / 2 on every side
            setattr(self, name, QConv2d(cin, cout, k, padding=(k - 1) // 2))

    def forward(self, image: torch.Tensor) -> list:
        """(B, H, W, 3) -> the 3 scoremaps, (B, 21, H / 8, W / 8) each."""
        x = image.permute(0, 3, 1, 2)
        for p in self.plan:
            x = (F.max_pool2d(x, 2, 2) if p == "pool"
                 else leaky(getattr(self, p[0])(x)))
        encoding = x
        maps = [self.conv5_2(leaky(self.conv5_1(encoding)))]
        for stage in (6, 7):
            x = torch.cat([maps[-1], encoding], 1)
            for rec in range(1, 7):
                x = leaky(getattr(self, f"conv{stage}_{rec}")(x))
            maps.append(getattr(self, f"conv{stage}_7")(x))
        return maps


# --- data --------------------------------------------------------------


def record_bytes(size: int) -> int:
    return N_KP * 3 * 4 + N_KP * 2 * 4 + 9 * 4 + 2 + size * size * 4 + N_KP


def read_records(path: str, indices, size: int) -> dict:
    """The records ``indices`` of the packed DB at ``path``, stacked."""
    n = record_bytes(size)
    out = {k: [] for k in ("xyz", "uv", "image", "mask", "vis")}
    with open(path, "rb") as fh:
        for i in indices:
            fh.seek(int(i) * n)
            raw = fh.read(n)
            if len(raw) != n:
                raise ValueError(f"record {i}: {len(raw)} of {n} bytes")
            f = np.frombuffer(raw, "<f4", count=N_KP * 5 + 9)
            at = (N_KP * 5 + 9) * 4
            if raw[at:at + 2] != b"\xff\xff":
                raise ValueError(f"record {i}: no sentinel")
            at += 2
            out["xyz"].append(f[:N_KP * 3].reshape(N_KP, 3))
            out["uv"].append(f[N_KP * 3:N_KP * 5].reshape(N_KP, 2))
            px = size * size
            out["image"].append(np.frombuffer(raw, np.uint8, px * 3, at)
                                .reshape(size, size, 3))
            out["mask"].append(np.frombuffer(raw, np.uint8, px, at + px * 3)
                               .reshape(size, size))
            out["vis"].append(np.frombuffer(raw, np.uint8, N_KP,
                                            at + px * 4))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


def uv_noise(uniforms: torch.Tensor) -> torch.Tensor:
    """(B, 42, 2) uniforms in [0, 1) -> the truncated normal of sigma 2.5,
    in float32 on the CPU."""
    u = uniforms.to("cpu", torch.float32)
    edge = math.erf(2.0 / math.sqrt(2.0))
    z = torch.erfinv(u * (2 * edge) - edge) * math.sqrt(2.0)
    return UV_NOISE_SIGMA * z.clamp(-2.0, 2.0)


def _palm(a: torch.Tensor) -> torch.Tensor:
    """Each hand's wrist (rows 0, 21) replaced by mean(row 0, row 12) of
    that hand."""
    left, right = a[:, :21].clone(), a[:, 21:].clone()
    left[:, 0] = 0.5 * (a[:, 0] + a[:, 12])
    right[:, 0] = 0.5 * (a[:, 21] + a[:, 33])
    return torch.cat([left, right], 1)


def hand_side_left(mask: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """(B,) True where the left hand is taken: more left-hand mask pixels
    than right-hand ones; with no hand pixel, more visible keypoints, the
    left on a tie."""
    m = mask.long()
    n_left = ((m > 1) & (m < 18)).sum(dim=(1, 2))
    n_right = (m > 17).sum(dim=(1, 2))
    by_vis = vis[:, :21].sum(1) >= vis[:, 21:].sum(1)
    return torch.where((n_left + n_right) == 0, by_vis, n_left > n_right)


def scoremaps(uv21: torch.Tensor, vis21: torch.Tensor, size: int,
              sigma: float = SIGMA) -> torch.Tensor:
    """(B, 21, 2) uv and (B, 21) visibility -> (B, size, size, 21)."""
    c = torch.trunc(uv21)              # TF's cast to int32
    row, col = c[..., 1], c[..., 0]
    inside = (row > 0) & (row < size - 1) & (col > 0) & (col < size - 1)
    keep = (inside & vis21).float()
    r = torch.arange(size, dtype=torch.float32, device=uv21.device)
    d2 = ((r[None, :, None, None] - row[:, None, None, :]) ** 2
          + (r[None, None, :, None] - col[:, None, None, :]) ** 2)
    return torch.exp(-d2 / sigma ** 2) * keep[:, None, None, :]


def posenet_batch(records: dict, uniforms: torch.Tensor, size: int,
                  device) -> dict:
    """Raw records and the noise's uniforms -> image (B, S, S, 3),
    scoremap (B, S, S, 21), vis (B, 21) bool, left (B,) bool."""
    vis42 = records["vis"] > 0
    uv = _palm(records["uv"].float())
    vis = torch.cat([(vis42[:, 0] | vis42[:, 12])[:, None], vis42[:, 1:21],
                     (vis42[:, 21] | vis42[:, 33])[:, None],
                     vis42[:, 22:]], 1)
    uv = uv + uv_noise(uniforms)
    left = hand_side_left(records["mask"], vis)
    uv21 = torch.where(left[:, None, None], uv[:, :21], uv[:, 21:])
    vis21 = torch.where(left[:, None], vis[:, :21], vis[:, 21:])
    image = records["image"].float() / 255.0 - 0.5
    return {"image": image.to(device),
            "scoremap": scoremaps(uv21.to(device), vis21.to(device), size),
            "vis": vis21.to(device), "left": left.to(device)}


# --- loss and steps ----------------------------------------------------


def resize_bilinear_tf1(x: torch.Tensor, out_h: int, out_w: int
                        ) -> torch.Tensor:
    """TF1's default bilinear resize of NCHW ``x``."""
    h, w = x.shape[2], x.shape[3]

    def axis(n_in, n_out):
        src = torch.arange(n_out, dtype=torch.float32,
                           device=x.device) * (n_in / n_out)
        lo = src.floor().long()
        hi = torch.clamp(lo + 1, max=n_in - 1)
        return lo, hi, src - lo.float()

    y0, y1, fy = axis(h, out_h)
    x0, x1, fx = axis(w, out_w)
    top, bottom = x[:, :, y0], x[:, :, y1]
    rows = top + (bottom - top) * fy[:, None]
    left, right = rows[..., x0], rows[..., x1]
    return left + (right - left) * fx


def posenet_loss(maps: list, scoremap: torch.Tensor, vis: torch.Tensor
                 ) -> torch.Tensor:
    gt = scoremap.permute(0, 3, 1, 2)
    v = vis.float()
    loss = 0.0
    for m in maps:
        pred = resize_bilinear_tf1(m, gt.shape[2], gt.shape[3])
        per_kp = torch.sqrt(((pred - gt) ** 2).mean(dim=(2, 3)))
        loss = loss + (v * per_kp).sum() / (v.sum() + 0.001)
    return loss


def staged_lr(step: int) -> float:
    lr = LR_VALUES[0]
    for v, s in zip(LR_VALUES[1:], LR_STEPS):
        if step >= s:
            lr = v
    return lr


def train_steps(net: nn.Module, batches: list, first_step: int = 0,
                prefix: str = "posenet") -> dict:
    """PoseNet's steps on ``batches``: {"losses": [{"loss"}], "grad_norms":
    {leaf: its first gradient's norm}, "change_norms": {leaf: its change's
    norm}}, leaves ``<prefix>.<parameter>``."""
    params = dict(net.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    state, losses, grad_norms = {}, [], {}
    for i, b in enumerate(batches):
        loss = posenet_loss(net(b["image"]), b["scoremap"], b["vis"])
        grads = torch.autograd.grad(loss, list(params.values()))
        if i == 0:
            grad_norms = {f"{prefix}.{k}": float(g.norm())
                          for k, g in zip(params, grads)}
        adam_step(list(params.values()), grads, state,
                  staged_lr(first_step + i), BETAS, EPS)
        losses.append({"loss": float(loss.detach())})
    change = {f"{prefix}.{k}": float((p.detach() - start[k]).norm())
              for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
