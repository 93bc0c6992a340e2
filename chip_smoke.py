#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mmhand_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from mmhand_torch/csrc/ with nvcc.
2. Holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at a ragged one, and times it beside its plain
   version, its bound and, where one exists, the one PyTorch call that
   computes the same function: K1 (heatmaps; also on the main paths'
   keypoints and on its early-out's hard cases, with the share of elements
   it skips), K2 (BatchNorm sums) and K2b (their backward).  Each kernel's
   device time per call comes from the profiler beside its CUDA-event time,
   which includes the wrapper's host work.
3. Holds the port on the card against the port on the CPU (the path the
   tests hold against mmhand_tpu) on small inputs, in float32 with TF32
   off: batch preparation and a toy generator; two toy train steps.
4. Drives the generation path at full width (ngf 64, 9 PATBlocks, 256x256,
   batch norm, bf16 autocast, gen_batch 16) through
   ``mmhand_torch.scripts.aug.main`` over the synthetic dataset, counting the
   kernel launches of that run, then checks the written PNGs against the
   generator's output and the bf16 output against float32.
5. Drives the train step at full width (the flagship Config(), batch 16, 6
   steps) through ``mmhand_torch.scripts.train.main``, counting the kernel
   launches of that run; checks the losses of every step, that every
   network and running statistic moved, and that ``aug.main`` generates
   from the saved generator; times one step's phases and profiles one step,
   with K2's and K2b's bounds summed over the step's 101 BatchNorm calls.
6. Holds K3 (the jointsmap rasterizer) against its plain version run on the
   CPU, bit for bit, on poses, the baselines' poses and degenerate bones,
   with the share of (pixel, bone) pairs its tiles skip, and the
   evaluation modules on the card against the CPU
   (Inception, SSIM, the CPM judge, the conditioning image), in float32
   with TF32 off.
7. Drives the evaluation path at full width (256 px, 64 pairs of the
   synthetic dataset): ``mmhand_torch.scripts.evaluate_gan.main`` over the
   generator the train phase saved (eval_batch 16), then
   ``mmhand_torch.scripts.bench_baselines.main`` with the CycleGAN resnet
   (ngf 64, 9 blocks) and the pix2pix UNet (8 downs) at eval_batch 8,
   counting the kernel launches of each run; checks that every score is
   finite over 64 images and that K3 ran once per baseline batch; times one
   batch's parts and profiles one baseline batch.

Between the train and evaluation paths, the rest of the trainer:

8. The fp16 slice: 6 flagship steps through ``train()`` with
   ``PrecisionConfig(compute_dtype="float16", loss_scaling=True)``; checks
   finite losses and parameters and 101 K2/K2b launches per step; prints the
   rate, the overflow steps, the final scales and one step with and without
   the scalers (K2/K2b also run in f16 at (16, 64, 256, 256) in phase 2).
9. Resume: 3 flagship steps through ``scripts.train.main``, their
   ``state_latest.pt`` saved and restored into a fresh system tensor for
   tensor, 3 more with ``--continue_train`` up to step 6; then at toy size
   3 + 3 resumed steps against 6 unbroken ones (f32, TF32 off,
   deterministic algorithms), bit for bit wherever two unbroken runs agree,
   else within the train tests' bound.
10. Data parallelism at world size 1 over NCCL: ``torch.distributed.run``
    launches this script as one rank (``--dp-worker``), which runs 3 flagship
    steps through ``train(distributed=True)``; prints its step beside the
    single-process step and its all-reduces per step.
11. Two ranks on the one card over gloo (``--gloo-worker``): one toy DP step
    against the single-process step on the full batch.

After the evaluation path, the HPE slice and the ratio study:

12. HPE train: an RHD-layout crop tree (64 random images at 256 px, packed
    depth, annotation.pickle), then ``mmhand_torch.scripts.train_hpe.main
    --model hpm`` at full width (Hpm2d and Hpm3d, bf16 autocast) at batch
    32 for 6 steps, counting the kernel launches of that run (K1 once per
    step, at sigma 5); checks the losses and that the nets moved; holds K1
    at sigma 5 on the batch's keypoints at (32, 256, 256, 21) against its
    plain version; times one step (CUDA events) against its FLOP count and
    profiles it.
13. HPE test: ``mmhand_torch.scripts.test_hpe.main`` on that checkpoint,
    ``--model hpm`` and ``hpm3d``; every score finite (random weights, so
    structural only).
14. The ratio study: ``python -m mmhand_torch.scripts.mm_train_ratio`` at
    ratios 0.5 and 1.0 on that tree (the flagship GAN one epoch at batch
    32, aug, the HPE one epoch, test_hpe), each stage a process of its own
    that must exit 0; checks that aug wrote exactly the images
    ``HPEMixDataset`` marks, and prints each stage's command and summary.

After the ratio study, stages 1-2 from raw frames and the rest of the
baseline zoo:

15. Preprocessing: raw RHD-layout frames it writes (128 training and 32
    evaluation frames of 320x320, two hands each: the split into left and
    right, the right hand's flip, rejected hands and dropped masks run) and
    an STB-layout source (B1 and B4, SK_color, BB_left and BB_right 640x480
    frames, ``labels/*.mat``) through ``mmhand_torch.scripts.create_rhd_db``
    and ``create_stb_db`` to 256 px crops; checks every crop's keypoints
    inside it and B4 only under ``test/``, and prints crops per second.
16. The exports on the RHD training crops: ``export_baseline_formats``
    pairs, keypoints and pix2pixhd (K3 once per 64 labels, one batch held
    against the plain rasterizer run on the CPU bit for bit), then
    ``generate_pose_maps`` at 256x256, sigma 6.
17. CSV training: ``scripts.train --dataset MMHand`` on that chain, the
    flagship Config() at batch 16, bf16, 6 steps: finite losses and
    parameters, 101 K2 and K2b launches per step and no K1; one step by
    CUDA events and the host's read of one prerendered batch.
18. PATN2 scoring: ``bench_baselines --arch patn2`` (ngf 64, 9 blocks) over
    the RHD evaluation crops at eval batch 8: finite scores, K1 twice per
    batch, K1 held against its plain version on a batch's keypoints.
19. The library nets: PoseResNet-50 at batch 32 and 256 px (an eval
    forward; a train-mode forward and backward with K2/K2b at its 56
    BatchNorms; K2 over those inputs against ``torch.batch_norm_stats``;
    at batch 2 in float32 the output and running statistics against the
    CPU's plain version, the gradients against a float64 functional
    forward); NLayerDiscriminator, PixelDiscriminator and PATN2Stream
    against the CPU and in train mode on the card; every init_type on the
    flagship generator, each conv weight's std against its formula.

The kernels' JSON line gives each kernel's ``max_rel_err`` beside its
``max_abs_err`` where an absolute error alone misleads: K2's sums of
squares over 1M elements reach ~2.4e6, where one f32 ulp is 0.25.  It prints the kernels'
JSON line, then the card's name and power limit, then
``{"ok": true, "device": {...}}`` as the last line.  Any failed phase raises
and the exit code is not 0; without a CUDA device, or without the package
beside this file, it stops before printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
FULL = dict(size=256, ngf=64, gen_batch=16, n_items=64)
K1_REPLACES = "mmhand_tpu/ops/heatmap.py:73"
K2_REPLACES = "mmhand_tpu/ops/bn_stats.py:87"
K2B_REPLACES = "mmhand_tpu/ops/bn_stats.py:73"
K3_REPLACES = "mmhand_tpu/ops/jointsmap.py:115"
BN_SOURCE = "mmhand_torch/csrc/bn_stats.cu"
# each kernel's CUDA kernels, by the names the profiler shows
K1_KERNELS = ("gaussian_heatmaps_kernel",)
K2_KERNELS = ("bn_sums_partial_kernel", "bn_sums_finish_kernel")
K2B_KERNELS = ("bn_sums_backward_kernel",)
K3_KERNELS = ("jointsmap_kernel",)
# the largest BatchNorm input of the train step (in bf16, and in f16 for the
# fp16 slice), a PATBlock attention stream's, and a ragged shape in f32
BN_SHAPES = [((16, 64, 256, 256), "bfloat16"), ((16, 64, 256, 256), "float16"),
             ((16, 512, 64, 64), "bfloat16"), ((3, 29, 37, 41), "float32")]
# the train slice: the JAX Config() flagship (ngf 64, 9 PATBlocks, 256 px),
# batch 16, a few steps; its BatchNorms: 47 in G, 9 in each D, run once in
# G, twice in the G loss's D forwards and twice in each D phase
TRAIN = dict(steps=6, batch=16)
# the resume and NCCL slices: 3 flagship steps each (3 + 3 for resume)
RESUME_STEPS = 3
BN_PER_STEP = 47 + 2 * 9 + 2 * 9 + 2 * 9
# the evaluation slice: 64 pairs at 256 px; evaluate_gan at batch 16, the
# baselines at batch 8 (the JAX scripts' defaults)
EVAL = dict(n_items=64, gan_batch=16, baseline_batch=8)
# K3's shapes: the baselines' batch, the generation batch, a ragged one,
# then the edge cases at batch 2
K3_SHAPES = [("poses", 8, 256, 256), ("poses", 16, 256, 256),
             ("poses", 3, 70, 90), ("occlusion", 2, 256, 256),
             ("tie", 2, 256, 256), ("zero_length", 2, 256, 256),
             ("parked", 2, 256, 256), ("tiny", 2, 256, 256),
             ("floor", 2, 256, 256), ("nan", 2, 256, 256),
             ("long", 2, 256, 256), ("graze", 2, 256, 256),
             ("graze", 3, 70, 90)]
# f32 operations per pixel and bone in K3: 2 subtractions, 6 products and
# 3 sums, 2 divisions, 2 comparisons, 1 select
K3_OPS_PER_PIXEL_BONE = 16
# the HPE slice: an RHD-layout tree of 64 images at 256 px; --model hpm at
# the ratio driver's batch of 32 (scripts/mm_train_ratio.py:44), 6 steps;
# test_hpe at its default eval_batch of 8
HPE = dict(n_items=64, batch=32, steps=6, eval_batch=8)
# stages 1-2 from raw frames: RHD-layout sources of 320x320 frames with
# two hands each (training and evaluation splits) and an STB-layout source
# (B1 and B4, three 640x480 views), cropped to 256 px; the pix2pixhd labels
# rasterized 64 to a K3 launch
PRE = dict(rhd_frames=128, rhd_eval_frames=32, stb_frames=32, label_batch=64)
# the CSV chain: the flagship Config() on the prerendered training crops at
# batch 16, 6 steps, pose maps at sigma 6
CSV_TRAIN = dict(batch=16, steps=6, sigma=6.0)
# PATN2 scoring of the evaluation crops at the JAX script's eval batch
PATN2 = dict(batch=8)
# PoseResNet-50 (SimpleBaselines) with its 56 BatchNorms: batch 32 at 256 px,
# against the CPU at batch 2
POSE = dict(size=50, batch=32, cpu_batch=2, bn_sites=56)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
F32_FLOPS = 67e12           # H100 SXM, outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM, dense bf16 on the tensor cores


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 500) -> float:
    """Mean host microseconds of one call of ``fn`` by the host clock, after
    warm-up and without a synchronise inside: with a tiny launch, the
    wrapper's host work (checks, allocation, device guard, stream, the
    launch), which an isolated call's CUDA-event time adds to its device
    time."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e6


@contextlib.contextmanager
def tf32_off():
    """Full float32 in cuDNN convolutions (TF32 by default) and matmuls."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def heatmap_error(got, want, uv, height, width, sigma):
    """Max |got - want| off the clip boundary: pixels whose unclipped
    Gaussian (float64) lies within 1e-6 of 0.0099 are exempt, because there a
    last-bit difference in exp flips the clip and jumps by 0.0099."""
    import torch

    from mmhand_torch.ops.heatmap import CLIP_LO

    u = uv.double()
    rows = torch.arange(height, device=uv.device, dtype=torch.float64)
    cols = torch.arange(width, device=uv.device, dtype=torch.float64)
    d2 = ((cols[:, None] - u[..., 0][..., None, None, :]) ** 2
          + (rows[:, None, None] - u[..., 1][..., None, None, :]) ** 2)
    g = torch.exp(-d2 / (2.0 * sigma * sigma))
    keep = (g - CLIP_LO).abs() > 1e-6
    return float(((got - want).abs() * keep).max()), int((~keep).sum())


def heatmap_case(name: str, sigma: float, batch: int, height: int,
                 width: int):
    """K1's early-out cases of tests/test_torch_cuda.py (on the CPU):
    keypoints on the frame's edges and corners (edges), off it (off_frame),
    or with pixel (30, 10 + dy) at d^2 within a few ulps of the threshold
    (near_threshold)."""
    import numpy as np
    import torch

    from mmhand_torch.ops.heatmap import skip_d2

    rng = np.random.RandomState(SEED)
    size = np.array([width - 1, height - 1], np.float32)
    uv = rng.uniform(0, 1, (batch, 21, 2)) * size
    if name == "edges":
        side = rng.randint(0, 2, (batch, 21))
        edge = rng.randint(0, 2, (batch, 21)) * size[side]
        np.put_along_axis(uv, side[..., None], edge[..., None], -1)
        uv[:, :4] = [[0, 0], [width - 1, 0], [0, height - 1], size]
        uv[:, 4:8] += rng.choice([-0.5, 0.5], (batch, 4, 2))
    elif name == "off_frame":
        far = rng.uniform(0.5, 40, (batch, 21))
        uv[:, :7, 0] = -far[:, :7]
        uv[:, 7:14, 0] = width - 1 + far[:, 7:14]
        uv[:, 14:, 1] = rng.choice([-1, 1], (batch, 7)) * (height + far[:, 14:])
    elif name == "near_threshold":
        t = np.float64(np.float32(skip_d2(sigma)))
        dy = np.arange(21) % int(np.sqrt(t))
        eps = rng.choice([-3e-7, -1e-7, 0.0, 1e-7, 3e-7], (batch, 21))
        uv = np.stack(np.broadcast_arrays(
            30.0 - np.sqrt(t * (1 + eps) - dy * dy), 10.0 - dy), -1)
    return torch.from_numpy(np.asarray(uv, np.float32))


def check_heatmaps(uv, height: int, width: int, sigma: float, what: str):
    """K1 on the card against the plain version on the card (max |error|
    off the clip boundary at most 1e-6: the plain version on CUDA divides by
    2 sigma^2 as a multiply by its reciprocal, K1 divides), and 0 wherever
    the early-out skipped, as the plain version is there.  Returns (error,
    exempt pixels, skipped share)."""
    import torch

    from mmhand_torch.ops.heatmap import (
        gaussian_heatmaps,
        gaussian_heatmaps_ref,
        skipped_elements,
    )

    got = gaussian_heatmaps(uv, height, width, sigma)
    torch.cuda.synchronize()
    want = gaussian_heatmaps_ref(uv, height, width, sigma)
    check(got.shape == want.shape == uv.shape[:-2] + (height, width, 21),
          f"K1 {what}: shape {tuple(got.shape)}")
    err, exempt = heatmap_error(got, want, uv, height, width, sigma)
    check(err <= 1e-6, f"K1 {what}: differs from the plain version by {err}")
    check(exempt <= 1e-3 * got.numel(), f"K1 {what}: {exempt} pixels exempt")
    skipped = skipped_elements(uv, height, width, sigma)
    check(not bool(want[skipped].any()) and not bool(got[skipped].any()),
          f"K1 {what}: an element the early-out skips is not 0")
    return err, exempt, float(skipped.float().mean())


def kernel_phase():
    """K1 against gaussian_heatmaps_ref on the card, at the main paths'
    shape, on the main paths' keypoints, on the early-out's hard cases and
    at a ragged shape; returns its record."""
    import torch

    from mmhand_torch.config import Config, DataConfig, ModelConfig
    from mmhand_torch.ops.heatmap import gaussian_heatmaps, gaussian_heatmaps_ref

    rng = torch.Generator().manual_seed(SEED)
    batch, size, sigma = FULL["gen_batch"], FULL["size"], 6.0
    uv = ((torch.rand(batch, 21, 2, generator=rng) * 1.2 - 0.1) * size).cuda()
    err, exempt, skipped = check_heatmaps(uv, size, size, sigma, "uniform")
    ms = cuda_ms(lambda: gaussian_heatmaps(uv, size, size, sigma))
    device_ms = kernel_device_ms(
        lambda: gaussian_heatmaps(uv, size, size, sigma), K1_KERNELS)
    plain_ms = cuda_ms(lambda: gaussian_heatmaps_ref(uv, size, size, sigma))
    out_bytes = batch * size * size * 21 * 4
    # f32 writes of the output; the exp and its ~9 operations only where
    # the early-out leaves an element
    k1_bound, k1_by = bound(out_bytes + uv.numel() * 4,
                            9 * (1 - skipped) * out_bytes / 4)
    tiny = uv[:1] * (8.0 / size)
    wrapper_us = host_us(lambda: gaussian_heatmaps(tiny, 8, 8, sigma))
    print(f"K1 gaussian_heatmaps ({batch}, {size}, {size}, 21), keypoints "
          f"uniform over the frame +-10%: max_abs_err {err} ({exempt} "
          f"clip-boundary pixels exempt); early-out skips {skipped:.4f} of "
          f"the elements; kernel {ms:.4f} ms per call ({device_ms:.4f} ms of "
          f"device time, profiler; the wrapper's host work {wrapper_us:.1f} "
          f"us per call at (1, 8, 8)), plain {plain_ms:.4f} ms, bound "
          f"{k1_bound:.4f} ms ({k1_by}); no single PyTorch call computes the "
          f"same function")
    record = {"name": "gaussian_heatmaps", "route": "cuda",
              "source": "mmhand_torch/csrc/heatmap.cu",
              "replaces": K1_REPLACES, "max_abs_err": err,
              "max_rel_err": None, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
              "library_ms": None, "device_ms": device_ms}

    # the keypoints the main paths render: the synthetic set's first batch
    cfg = Config(model=ModelConfig(fine_size=size),
                 data=DataConfig(dataset="synthetic"), is_train=False)
    raw = raw_batch(cfg, batch)
    for side in ("src_uv", "tgt_uv"):
        uv = torch.from_numpy(raw[side]).cuda()
        err, exempt, skipped = check_heatmaps(uv, size, size, sigma, side)
        ms = cuda_ms(lambda: gaussian_heatmaps(uv, size, size, sigma))
        device_ms = kernel_device_ms(
            lambda: gaussian_heatmaps(uv, size, size, sigma), K1_KERNELS)
        print(f"K1 on the main paths' {side} ({batch}, {size}, {size}, 21): "
              f"max_abs_err {err} ({exempt} exempt); early-out skips "
              f"{skipped:.4f} of the elements; kernel {ms:.4f} ms per call "
              f"({device_ms:.4f} ms of device time)")
        if side == "tgt_uv":
            record["skipped_share"] = skipped

    for name in ("edges", "off_frame", "near_threshold"):
        for s in (5.0, 6.0):
            for b, h, w in ((batch, size, size), (3, 70, 90)):
                uv = heatmap_case(name, s, b, h, w).cuda()
                err, exempt, skipped = check_heatmaps(uv, h, w, s, name)
                print(f"K1 {name} sigma {s} ({b}, {h}, {w}, 21): max_abs_err "
                      f"{err} ({exempt} exempt), skips {skipped:.4f}")
    return record


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least milliseconds for the work on an H100 SXM at 700 W: bytes over
    3.35 TB/s of HBM, f32 operations over 67 TFLOP/s, whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def bn_errors(x, g1, g2):
    """K2 and K2b on ``x`` (channels_last, on the card) against their plain
    versions.  Returns K2's relative errors of sum x and sum x^2, its
    largest absolute error, K2b's largest difference and K2b's output.
    K2 sums in f32 in another order than the plain version, so its error is
    held relative to sum |x| and sum x^2, which bound the rounding of any
    order; K2b is the plain formula in the same order, one rounding per
    operation, so it must agree bit for bit."""
    import torch

    from mmhand_torch.ops.bn_stats import (
        bn_sums,
        bn_sums_backward,
        bn_sums_backward_ref,
        bn_sums_ref,
    )

    s1, s2 = bn_sums(x)
    torch.cuda.synchronize()
    r1, r2 = bn_sums_ref(x)
    scale1 = x.float().abs().sum((0, 2, 3)).clamp_min(1e-30)
    rel1 = float(((s1 - r1).abs() / scale1).max())
    rel2 = float(((s2 - r2).abs() / r2.clamp_min(1e-30)).max())
    err = max(float((s1 - r1).abs().max()), float((s2 - r2).abs().max()))
    dx = bn_sums_backward(x, g1, g2)
    torch.cuda.synchronize()
    bwd_err = float((dx.float() - bn_sums_backward_ref(x, g1, g2).float()
                     ).abs().max())
    return rel1, rel2, err, bwd_err, dx


def hold_bn_inputs(what: str, inputs) -> str:
    """K2 and K2b on each BatchNorm input that a path gave them, at the
    path's shapes and type, against their plain versions with
    ``bn_errors``' tolerances; returns the line to print."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst_rel, worst_bwd = 0.0, 0.0
    for i, x in enumerate(inputs):
        c = x.shape[1]
        g1 = torch.randn(c, generator=gen, device="cuda")
        g2 = torch.randn(c, generator=gen, device="cuda")
        rel1, rel2, _, bwd_err, _ = bn_errors(x, g1, g2)
        where = f"{what}'s BatchNorm input {i} {tuple(x.shape)} {x.dtype}"
        check(rel1 <= 1e-5 and rel2 <= 1e-5,
              f"K2 on {where}: relative errors {rel1}, {rel2}")
        check(bwd_err == 0.0,
              f"K2b on {where}: differs from the plain version by {bwd_err}")
        worst_rel = max(worst_rel, rel1, rel2)
        worst_bwd = max(worst_bwd, bwd_err)
    types = sorted({str(x.dtype).removeprefix("torch.") for x in inputs})
    return (f"K2 and K2b on {what}'s {len(inputs)} BatchNorm inputs "
            f"({', '.join(types)}; C {min(x.shape[1] for x in inputs)}-"
            f"{max(x.shape[1] for x in inputs)}) against their plain "
            f"versions: K2 relative error at most {worst_rel:.3g}, K2b "
            f"{worst_bwd} from the plain version")


def bn_kernel_phase():
    """K2 and K2b against the plain version and its autograd on the card, in
    the working type; returns their records, at the largest shape."""
    import torch

    from mmhand_torch.ops.bn_stats import (
        bn_sums,
        bn_sums_backward,
        bn_sums_backward_ref,
        bn_sums_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = []
    for shape, dtype in BN_SHAPES:
        x = (torch.randn(shape, generator=gen, device="cuda") * 1.5 + 0.3
             ).to(getattr(torch, dtype)).contiguous(
                 memory_format=torch.channels_last)
        c = shape[1]
        g1 = torch.randn(c, generator=gen, device="cuda")
        g2 = torch.randn(c, generator=gen, device="cuda")
        rel1, rel2, err, bwd_err, dx = bn_errors(x, g1, g2)
        check(rel1 <= 1e-5 and rel2 <= 1e-5,
              f"K2 at {shape} {dtype}: relative errors {rel1}, {rel2}")
        check(dx.dtype == x.dtype and dx.shape == x.shape
              and dx.is_contiguous(memory_format=torch.channels_last),
              f"K2b output {dx.dtype} {tuple(dx.shape)}")
        check(bwd_err == 0.0, f"K2b differs from the plain version by {bwd_err}")
        # autograd of the plain sums adds 2 g2 x as g2 x + g2 x: one
        # rounding of the working type apart, at most
        xr = x.detach().requires_grad_()
        torch.autograd.backward(bn_sums_ref(xr), (g1, g2))
        eps = torch.finfo(x.dtype).eps
        tol = eps * (g1.abs().view(1, -1, 1, 1)
                     + 2 * (g2.view(1, -1, 1, 1) * x.float()).abs()) + 1e-30
        excess = float(((dx.float() - xr.grad.float()).abs() - tol).max())
        check(excess <= 0.0, "K2b differs from autograd beyond one rounding")
        del xr

        ms = cuda_ms(lambda: bn_sums(x))
        plain_ms = cuda_ms(lambda: bn_sums_ref(x))
        library_ms = cuda_ms(lambda: torch.batch_norm_stats(x, 1e-5))
        bwd_ms = cuda_ms(lambda: bn_sums_backward(x, g1, g2))
        bwd_plain_ms = cuda_ms(lambda: bn_sums_backward_ref(x, g1, g2))
        nbytes = x.numel() * x.element_size()
        k2_bound, k2_by = bound(nbytes + 2 * c * 4, 3 * x.numel())
        k2b_bound, k2b_by = bound(2 * nbytes + 2 * c * 4, 2 * x.numel())
        print(f"K2 bn_sums {shape} {dtype}: rel err {rel1:.3g}/{rel2:.3g}, "
              f"max_abs_err {err}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, torch.batch_norm_stats {library_ms:.4f} ms, bound "
              f"{k2_bound:.4f} ms ({k2_by})")
        print(f"K2b bn_sums_backward {shape} {dtype}: max_abs_err {bwd_err} "
              f"against the plain version; kernel {bwd_ms:.4f} ms, plain "
              f"{bwd_plain_ms:.4f} ms, bound {k2b_bound:.4f} ms ({k2b_by})")
        if not records:
            device_ms = kernel_device_ms(lambda: bn_sums(x), K2_KERNELS)
            bwd_device_ms = kernel_device_ms(
                lambda: bn_sums_backward(x, g1, g2), K2B_KERNELS)
            print(f"K2 / K2b at {shape}: {device_ms:.4f} / {bwd_device_ms:.4f} "
                  f"ms of device time per call (profiler)")
            records = [
                {"name": "bn_sums", "route": "cuda", "source": BN_SOURCE,
                 "replaces": K2_REPLACES, "max_abs_err": err,
                 "max_rel_err": max(rel1, rel2), "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": k2_bound,
                 "bound_by": k2_by, "library_ms": library_ms,
                 "device_ms": device_ms, "skipped_share": None},
                {"name": "bn_sums_backward", "route": "cuda",
                 "source": BN_SOURCE, "replaces": K2B_REPLACES,
                 "max_abs_err": bwd_err, "max_rel_err": None,
                 "ms": bwd_ms,
                 "plain_ms": bwd_plain_ms, "bound_ms": k2b_bound,
                 "bound_by": k2b_by, "library_ms": None,
                 "device_ms": bwd_device_ms, "skipped_share": None}]
        del x, dx

    raised = False
    try:
        bn_sums(torch.zeros(2, 8, 4, 4, device="cuda"))
    except ValueError:
        raised = True
    check(raised, "K2 took a tensor that is not channels_last")
    return records


def raw_batch(cfg, n):
    from mmhand_torch.data import HostLoader, build_dataset

    loader = HostLoader(build_dataset(cfg), n, seed=cfg.data.seed,
                        shuffle=False, max_items=n)
    raw = next(iter(loader.epoch(0)))
    return {k: v for k, v in raw.items() if not k.endswith("paths")}


def calibrate(generator, batch):
    """Running statistics from one train-mode pass (momentum 1, dropout
    off), as a trained network would carry them: random init weights with
    init statistics would shrink the signal to nothing."""
    import torch
    from torch import nn

    from mmhand_torch.models.layers import BatchNorm2d

    bns = [m for m in generator.modules() if isinstance(m, BatchNorm2d)]
    generator.train()
    for m in generator.modules():
        if isinstance(m, nn.Dropout):
            m.eval()
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        generator((batch["H1"], torch.cat([batch["P1"], batch["P2"]], -1),
                   torch.cat([batch["D1"], batch["D2"]], -1)))
    for m in bns:
        m.momentum = 0.1
    generator.eval()


def small_reference_phase():
    """The port on the card against the port on the CPU, float32, TF32 off."""
    import torch

    from mmhand_torch.config import Config, DataConfig, ModelConfig, PrecisionConfig
    from mmhand_torch.data import make_prepare_batch
    from mmhand_torch.train.state import build_generator
    from mmhand_torch.train.step import make_eval_step

    cfg = Config(model=ModelConfig(fine_size=32, ngf=8, g_n_blocks=2),
                 data=DataConfig(dataset="synthetic", seed=SEED),
                 precision=PrecisionConfig(compute_dtype="float32"),
                 is_train=False)
    raw = raw_batch(cfg, 4)
    on_cpu = make_prepare_batch(6.0, "cpu")(raw)
    on_card = make_prepare_batch(6.0, "cuda")(raw)
    # torch on CUDA divides by a Python scalar as a multiply by its
    # reciprocal, the CPU divides: a last-bit difference, 2 ulps at most
    for k in ("H1", "D1", "H2", "D2"):
        err = float((on_card[k].cpu() - on_cpu[k]).abs().max())
        check(err <= 2.5e-7, f"prepare {k} differs by {err}")
    for k, src in (("P1", "src_uv"), ("P2", "tgt_uv")):
        uv = torch.from_numpy(raw[src]).cuda()
        err, _ = heatmap_error(on_card[k], on_cpu[k].cuda(), uv, 32, 32, 6.0)
        check(err <= 1e-6, f"prepare {k} differs by {err}")

    g_cpu = build_generator(cfg, "cpu", seed=SEED)
    calibrate(g_cpu, on_cpu)
    g_card = build_generator(cfg, "cuda", seed=SEED)
    g_card.load_state_dict(g_cpu.state_dict())
    want = make_eval_step(g_cpu)(on_cpu)
    with tf32_off():
        got = make_eval_step(g_card)(on_card).cpu()
    err = float((got - want).abs().max())
    # cuDNN and the CPU sum the taps in another order; f32 with TF32 off
    check(err <= 1e-4, f"toy generator on the card differs from the CPU by {err}")
    print(f"small reference: prepare within 2 ulps, toy generator "
          f"max_abs_err {err}")


def nets_agree(got, want, updates: int, lr: float) -> str:
    """The three networks of two train systems after ``updates`` Adam updates
    each: at most 0.5% of a network's elements outside rtol 1e-3 / atol 2e-5
    (running statistics atol 1e-5), none more than 2 lr per update apart.
    Adam divides each gradient by its own magnitude, so an element whose
    gradient is near zero takes an update that f32 rounding decides
    (tests/test_torch_train.py).  Returns a summary."""
    summary = []
    for name in ("generator", "d_pb", "d_pp"):
        a = getattr(got, name).state_dict()
        b = getattr(want, name).state_dict()
        outside = total = 0
        worst = 0.0
        for k, v in b.items():
            if k.endswith("num_batches_tracked"):
                continue
            diff = (a[k].detach().cpu().float() - v.detach().cpu().float()).abs()
            atol = 1e-5 if "running" in k else 2e-5
            outside += int((diff > atol + 1e-3 * v.detach().cpu().abs()).sum())
            total += v.numel()
            worst = max(worst, float(diff.max()))
        check(outside <= 0.005 * total and worst <= 2 * lr * updates,
              f"{name}: {outside} of {total} elements differ, worst {worst}")
        summary.append(f"{name} {outside}/{total} outside, max {worst:.3g}")
    return "; ".join(summary)


def small_train_phase():
    """The toy train step on the card against the CPU, from the same weights
    and batches: float32, TF32 off, dropout off, pool 0, 2 steps."""
    import warnings

    from mmhand_torch.config import (
        Config,
        DataConfig,
        ModelConfig,
        OptimConfig,
        PrecisionConfig,
    )
    from mmhand_torch.data import make_prepare_batch
    from mmhand_torch.train.state import build_system
    from mmhand_torch.train.step import make_train_step

    cfg = Config(model=ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=2,
                                   n_layers_d=2, use_dropout_g=False,
                                   use_dropout_d=False),
                 optim=OptimConfig(pool_size=0),
                 data=DataConfig(dataset="synthetic", seed=SEED),
                 precision=PrecisionConfig(compute_dtype="float32"))
    lr = cfg.optim.lr
    raw = raw_batch(cfg, 4)
    full = make_prepare_batch(6.0, "cpu")(raw)
    batches = [{k: v[i:i + 2] for k, v in full.items()} for i in (0, 2)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning, twice
        on_cpu = build_system(cfg, "cpu")
        on_card = build_system(cfg, "cuda")
    step_cpu, step_card = make_train_step(on_cpu), make_train_step(on_card)
    worst = 0.0
    with tf32_off():
        for batch in batches:
            want = step_cpu(batch, lr)
            got = step_card({k: v.cuda() for k, v in batch.items()}, lr)
            for k, v in want.items():
                # losses: the tests' tolerance against JAX, rtol/atol 2e-4
                err = abs(float(got[k]) - float(v))
                check(err <= 2e-4 * (1 + abs(float(v))),
                      f"toy step loss {k}: card {float(got[k])}, cpu {float(v)}")
                worst = max(worst, err)
    summary = nets_agree(on_card, on_cpu, len(batches), lr)
    print(f"small train reference (2 steps, f32, TF32 off): losses within "
          f"{worst:.3g}; {summary}")


def slice_phase(tmp: Path):
    """The full-width generation path through aug.main; returns K1 launches."""
    import torch

    from mmhand_torch.config import Config, DataConfig, ModelConfig
    from mmhand_torch.data import make_prepare_batch
    from mmhand_torch.ops.heatmap import gaussian_heatmaps
    from mmhand_torch.ops.image import denormalize_image
    from mmhand_torch.scripts import aug
    from mmhand_torch.train.state import build_generator
    from mmhand_torch.train.step import make_eval_step
    from mmhand_torch.utils.checkpoint import save_network
    from mmhand_torch.utils.png import encode_png, read_png

    size, n_items, gen_batch = FULL["size"], FULL["n_items"], FULL["gen_batch"]
    cfg = Config(model=ModelConfig(fine_size=size, ngf=FULL["ngf"]),
                 data=DataConfig(dataset="synthetic", seed=49),
                 is_train=False)
    check(cfg.model.g_n_blocks == 9 and cfg.model.norm == "batch"
          and cfg.precision.compute_dtype == "bfloat16", "flagship config")
    raw = raw_batch(cfg, gen_batch)
    prepare = make_prepare_batch(cfg.data.sigma, "cuda")
    batch = prepare(raw)
    g = build_generator(cfg, "cuda", seed=SEED)
    n_params = sum(p.numel() for p in g.parameters())
    calibrate(g, batch)
    save_network(g, str(tmp / "ckpt"), "smoke")
    print(f"generator: {n_params} parameters, saved to {tmp / 'ckpt' / 'smoke'}")

    dst = tmp / "fakes"
    argv = ["--dataset", "synthetic", "--fineSize", str(size),
            "--ngf", str(FULL["ngf"]),
            "--max_dataset_size", str(n_items), "--gen_batch", str(gen_batch),
            "--checkpoints_dir", str(tmp / "ckpt"), "--name", "smoke",
            "--dst", str(dst), "--device", "cuda"]
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    gaussian_heatmaps.launches = 0
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        written = aug.main(argv)
    seconds = time.perf_counter() - start
    launches = gaussian_heatmaps.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(out.getvalue().strip())
    files = sorted((dst / "tgt").glob("*.png"))
    check(written == n_items and len(files) == n_items,
          f"{written} written, {len(files)} PNGs on disk, {n_items} expected")
    check(launches == 2 * (n_items // gen_batch),
          f"K1 launched {launches} times in the slice")
    rate = re.search(r"([0-9.]+) images/s after the first batch", out.getvalue())
    check(rate is not None, "aug printed no steady rate")
    print(f"slice: {written} fakes in {seconds:.3f} s, "
          f"{float(rate.group(1))} images/s after the first batch, "
          f"peak device memory {peak_gib:.2f} GiB, K1 launches {launches}")

    # what was written is the generator's output for that batch, finite
    eval_step = make_eval_step(g)
    fake = eval_step(batch)
    check(fake.shape == (gen_batch, size, size, 3) and fake.dtype == torch.float32,
          f"fake shape {tuple(fake.shape)} {fake.dtype}")
    check(bool(torch.isfinite(fake).all()), "non-finite generator output")
    u8 = denormalize_image(fake).cpu().numpy()
    for i in range(gen_batch):
        png = read_png(str(dst / "tgt" / f"{i:05d}.png")).astype(int)
        check(abs(png - u8[i]).max() <= 1, f"PNG {i} is not the generator's output")
    print(f"fakes: std {float(fake.std())}, PNGs match the generator's output")

    # bf16 autocast against f32 (TF32 off) on the same batch and weights
    g.compute_dtype = None
    with tf32_off():
        want = eval_step(batch)
    g.compute_dtype = torch.bfloat16
    diff = (fake - want).abs()
    max_err, mean_err = float(diff.max()), float(diff.mean())
    # bf16 keeps 8 significant bits; its rounding compounds over ~45 layers
    check(max_err <= 0.25 and mean_err <= 0.02,
          f"bf16 vs f32: max {max_err}, mean {mean_err}")
    print(f"bf16 vs f32 (TF32 off): max_abs_err {max_err}, mean_abs_err {mean_err}")

    # where a batch's time goes, one part at a time
    prep_ms = cuda_ms(lambda: prepare(raw), iters=10)
    gen_ms = cuda_ms(lambda: eval_step(batch), iters=10)
    fetch_ms = cuda_ms(lambda: denormalize_image(fake).cpu(), iters=10)
    start = time.perf_counter()
    for i in range(gen_batch):
        encode_png(u8[i])
    png_ms = (time.perf_counter() - start) * 1e3
    print(f"per batch of {gen_batch}: prepare {prep_ms:.3f} ms, generator "
          f"{gen_ms:.3f} ms, denormalize+fetch {fetch_ms:.3f} ms (CUDA "
          f"events); PNG encode {png_ms:.3f} ms (host clock)")
    return launches


# the kernel of torch.cuda._sleep, which pad_trace_start launches
PAD_KERNEL = "spin_kernel"


def pad_trace_start() -> None:
    """Launch and finish 32 short spin kernels at the start of a profiler
    window.  Once the process has run a while, the H100's trace drops the
    first ~10 device activities of a window (a UNet batch lost its
    jointsmap_kernel, copy and normalize after 12-100 s of idle card); the
    pad takes their place."""
    import torch

    for _ in range(32):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def profile_step(fn, what: str, kernels: dict[str, tuple[str, ...]]):
    """One call of ``fn`` under torch.profiler: the device time of the
    port's kernels (label -> the names of its kernels; a kernel that two
    labels name fails), of all kernels, and the device's busy share of the
    window.  Returns (a report, {label: (ms, launches)}); a profiler that
    yields no device time is reported, not failed, and gives {}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad_trace_start()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    sums = {k: [0.0, 0] for k in kernels}
    total = 0.0
    rows = []
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or PAD_KERNEL in ev.key):
            continue
        us = getattr(ev, "self_device_time_total", 0.0)
        labels = [k for k, names in kernels.items()
                  if any(name in ev.key for name in names)]
        check(len(labels) <= 1, f"{ev.key} counts under {labels}")
        for label in labels:
            sums[label][0] += us / 1e3
            sums[label][1] += ev.count
        if us:
            rows.append((us / 1e3, ev.count, ev.key))
            total += us / 1e3
    if not total:
        return (f"profiled {what}: no device time in the trace (not "
                f"measured)", {})
    top = "\n".join(f"  {ms:9.3f} ms {n:5d}x {key[:90]}"
                    for ms, n, key in sorted(rows, reverse=True)[:12])
    ours = "".join(f"{k} {ms:.4f} ms in {n} launches, "
                   for k, (ms, n) in sums.items())
    return (f"profiled {what}: {ours}all kernels {total:.3f} ms of "
            f"{wall_ms:.3f} ms wall (device busy {100 * total / wall_ms:.1f}%); "
            f"top kernels:\n{top}", {k: tuple(v) for k, v in sums.items()})


def bn_step_bounds(step, batch, lr, sums: dict) -> str:
    """K2's and K2b's bounds per train step: the sum over the step's
    train-mode BatchNorm calls of each call's bound (K2 reads x, K2b reads x
    and writes dx), beside their profiled device time per step."""
    from mmhand_torch.models.layers import BatchNorm2d

    sites = []

    def record(module, args):
        if module.training:
            x = args[0]
            sites.append((x.numel(), x.element_size(), x.shape[1]))

    nets = (step.system.generator, step.system.d_pb, step.system.d_pp)
    hooks = [m.register_forward_pre_hook(record) for net in nets
             for m in net.modules() if isinstance(m, BatchNorm2d)]
    try:
        step(batch, lr)
    finally:
        for h in hooks:
            h.remove()
    check(len(sites) == BN_PER_STEP, f"{len(sites)} BatchNorm calls per step")
    k2 = sum(bound(n * e + 2 * c * 4, 3 * n)[0] for n, e, c in sites)
    k2b = sum(bound(2 * n * e + 2 * c * 4, 2 * n)[0] for n, e, c in sites)
    gb = sum(n * e for n, e, _ in sites) / 1e9
    line = (f"BatchNorm sites per train step: {len(sites)}, {gb:.3f} GB of "
            f"inputs; bound per step K2 {k2:.4f} ms, K2b {k2b:.4f} ms")
    for label, bound_ms in (("K2", k2), ("K2b", k2b)):
        if label in sums:
            ms, n = sums[label]
            line += (f"; {label} {ms:.4f} ms of device time in {n} launches "
                     f"(profiler), {100 * bound_ms / ms:.1f}% of its bound")
    return line


def train_slice_phase(tmp: Path) -> tuple[dict, float]:
    """The full-width train step through scripts.train.main, then its
    checkpoint through aug.main; returns the kernels' launches in the train
    run and one step's milliseconds by CUDA events."""
    import math
    import warnings

    import torch

    from mmhand_torch.config import Config, DataConfig, ModelConfig
    from mmhand_torch.data import make_prepare_batch
    from mmhand_torch.ops.bn_stats import bn_sums, bn_sums_backward
    from mmhand_torch.ops.heatmap import gaussian_heatmaps
    from mmhand_torch.scripts import aug
    from mmhand_torch.scripts import train as train_script
    from mmhand_torch.train.state import build_system
    from mmhand_torch.train.step import make_train_step

    steps, batch_size = TRAIN["steps"], TRAIN["batch"]
    size = FULL["size"]
    ckpt = tmp / "train_ckpt"
    argv = ["--dataset", "synthetic", "--batchSize", str(batch_size),
            "--fineSize", str(size), "--max_steps", str(steps),
            "--print_freq", "1", "--checkpoints_dir", str(ckpt),
            "--name", "train_smoke", "--device", "cuda"]
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    gaussian_heatmaps.launches = 0
    bn_sums.launches = bn_sums_backward.launches = 0
    start = time.perf_counter()
    with warnings.catch_warnings(), contextlib.redirect_stdout(out):
        warnings.simplefilter("ignore")  # the random-VGG warning
        result = train_script.main(argv)
    seconds = time.perf_counter() - start
    launches = {"gaussian_heatmaps": gaussian_heatmaps.launches,
                "bn_sums": bn_sums.launches,
                "bn_sums_backward": bn_sums_backward.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(out.getvalue().strip())

    cfg = result.system.config
    check(cfg.model.ngf == 64 and cfg.model.g_n_blocks == 9
          and cfg.model.n_layers_d == 3 and cfg.model.norm == "batch"
          and cfg.precision.compute_dtype == "bfloat16"
          and cfg.optim.pool_size == 50 and cfg.optim.dg_ratio == 1
          and cfg.loss.l1_type == "l1_plus_perL1", "flagship train config")
    check(result.steps == steps, f"{result.steps} steps taken")
    per_step = BN_PER_STEP
    check(launches["bn_sums"] == per_step * steps
          and launches["bn_sums_backward"] == per_step * steps
          and launches["gaussian_heatmaps"] == 2 * steps,
          f"launches in the train slice: {launches}")
    lines = re.findall(r"\(epoch: \d+, iters: (\d+), time: [^)]*\) (.*)",
                       out.getvalue())
    check(len(lines) == steps, f"{len(lines)} loss lines for {steps} steps")
    for it, rest in lines:
        values = dict(re.findall(r"(\w+): (\S+)", rest))
        check(set(values) == {"pair_L1loss", "pair_GANloss", "origin_L1",
                              "perceptual", "D_PP", "D_PB"}
              and all(math.isfinite(float(v)) for v in values.values()),
              f"step {it} losses {values}")

    # every network moved from its initial weights, and the running
    # statistics of the discriminators moved from their init (0, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        init = build_system(cfg, "cpu")
    for name in ("generator", "d_pb", "d_pp"):
        now = getattr(result.system, name).state_dict()
        was = getattr(init, name).state_dict()
        moved = [k for k in was if not k.endswith("num_batches_tracked")
                 and not torch.equal(now[k].cpu(), was[k])]
        weights = [k for k in was if k.endswith("weight")]
        stats = [k for k in was if "running" in k]
        check(set(weights) <= set(moved) and set(stats) <= set(moved),
              f"{name}: {sorted(set(weights + stats) - set(moved))[:4]} "
              f"did not move")
    for net in ("netG", "netD_PB", "netD_PP"):
        check((ckpt / "train_smoke" / f"latest_net_{net}.pth").exists(),
              f"latest_net_{net}.pth not written")

    # where one step's time goes, one phase at a time (CUDA events)
    system = result.system
    step = make_train_step(system)
    lr = cfg.optim.lr
    raw = raw_batch(cfg, batch_size)
    prepare = make_prepare_batch(cfg.data.sigma, "cuda")
    batch = prepare(raw)
    fake, _ = step.g_phase(batch, lr)
    h1, h2, p2 = batch["H1"], batch["H2"], batch["P2"]
    real_pp, fake_pp = torch.cat([h2, h1], -1), torch.cat([fake, h1], -1)
    real_pb, fake_pb = torch.cat([h2, p2], -1), torch.cat([fake, p2], -1)
    times = {
        "prepare": cuda_ms(lambda: prepare(raw), iters=5, warmup=1),
        "G phase": cuda_ms(lambda: step.g_phase(batch, lr), iters=5, warmup=1),
        "pool PP": cuda_ms(lambda: step.replay("pp", fake_pp), iters=5, warmup=1),
        "D_PP phase": cuda_ms(lambda: step.d_phase("pp", real_pp, fake_pp, lr),
                              iters=5, warmup=1),
        "pool PB": cuda_ms(lambda: step.replay("pb", fake_pb), iters=5, warmup=1),
        "D_PB phase": cuda_ms(lambda: step.d_phase("pb", real_pb, fake_pb, lr),
                              iters=5, warmup=1),
        "whole step": cuda_ms(lambda: step(batch, lr), iters=5, warmup=1),
    }
    report, sums = profile_step(
        lambda: step(batch, lr), "train step",
        {"K2": K2_KERNELS, "K2b": K2B_KERNELS})
    print(report)
    print(bn_step_bounds(step, batch, lr, sums))
    rate = result.images_per_sec
    check(rate is not None and rate > 0, "train printed no steady rate")
    print(f"train slice: {steps} steps at batch {batch_size} in {seconds:.3f} s "
          f"(build and cuDNN warm-up included), {rate} images/s after the "
          f"first step, peak device memory {peak_gib:.2f} GiB, launches "
          f"{launches}")
    print("train step phases at batch %d (CUDA events, median of 5, ms): %s"
          % (batch_size, ", ".join(f"{k} {v:.3f}" for k, v in times.items())))

    # the trained generator's checkpoint drives the generation path
    written = aug.main(["--dataset", "synthetic", "--fineSize", str(size),
                        "--max_dataset_size", str(batch_size),
                        "--gen_batch", str(batch_size),
                        "--checkpoints_dir", str(ckpt), "--name", "train_smoke",
                        "--dst", str(tmp / "train_fakes"), "--device", "cuda"])
    check(written == batch_size, f"aug wrote {written} fakes from the trained G")
    return launches, times["whole step"]


def kernel_counters() -> dict:
    """The port's kernel wrappers, each with its ``.launches`` count."""
    from mmhand_torch.ops.bn_stats import bn_sums, bn_sums_backward
    from mmhand_torch.ops.heatmap import gaussian_heatmaps
    from mmhand_torch.ops.jointsmap import generate_jointsmap

    return {"gaussian_heatmaps": gaussian_heatmaps, "bn_sums": bn_sums,
            "bn_sums_backward": bn_sums_backward,
            "generate_jointsmap": generate_jointsmap}


def flagship_config(ckpt: Path, name: str, **precision):
    """The JAX Config() flagship at batch 16 on the synthetic set, printing
    every step."""
    from mmhand_torch.config import (
        Config,
        DataConfig,
        ModelConfig,
        PrecisionConfig,
        RunConfig,
    )

    return Config(model=ModelConfig(fine_size=FULL["size"]),
                  data=DataConfig(dataset="synthetic",
                                  batch_size=TRAIN["batch"]),
                  precision=PrecisionConfig(**precision),
                  run=RunConfig(checkpoints_dir=str(ckpt), name=name,
                                print_freq=1))


def nets_finite(system) -> bool:
    import torch

    return all(bool(torch.isfinite(v.float()).all())
               for net in (system.generator, system.d_pb, system.d_pp)
               for k, v in net.state_dict().items()
               if not k.endswith("num_batches_tracked"))


def fp16_train_phase(tmp: Path) -> dict:
    """Six flagship steps through ``train()`` in float16 with the three
    dynamic loss scalers; returns the kernels' launches in that run."""
    import math
    import warnings

    import torch

    from mmhand_torch.data import make_prepare_batch
    from mmhand_torch.train.loop import train
    from mmhand_torch.train.step import make_train_step

    steps = TRAIN["steps"]
    cfg = flagship_config(tmp / "fp16_ckpt", "fp16", compute_dtype="float16",
                          loss_scaling=True)
    counters = kernel_counters()
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    with warnings.catch_warnings(), contextlib.redirect_stdout(out):
        warnings.simplefilter("ignore")  # the random-VGG warning
        result = train(cfg, device="cuda", max_steps=steps)
    launches = {k: f.launches for k, f in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    system = result.system
    check(result.steps == steps and system.step == steps,
          f"fp16: {result.steps} steps taken")
    check(launches["bn_sums"] == BN_PER_STEP * steps
          and launches["bn_sums_backward"] == BN_PER_STEP * steps
          and launches["gaussian_heatmaps"] == 2 * steps,
          f"fp16 launches {launches}")
    lines = re.findall(r"\(epoch: \d+, iters: \d+, time: [^)]*\) (.*)",
                       out.getvalue())
    check(len(lines) == steps, f"fp16: {len(lines)} loss lines")
    overflows = 0
    for rest in lines:
        values = {k: float(v) for k, v in re.findall(r"(\w+): (\S+)", rest)}
        check(all(math.isfinite(v) for v in values.values())
              and "amp_overflow" in values, f"fp16 losses {values}")
        overflows += int(values["amp_overflow"])
    check(nets_finite(system), "fp16: a parameter or statistic is not finite")
    scales = {k: float(v.scale) for k, v in system.scales.items()}
    check(all(1.0 <= v <= 2.0 ** 16 for v in scales.values()),
          f"fp16 scales {scales}")

    # what the scaled path costs: the same fp16 step with the scalers off
    # (one flat gradient buffer per net, unscale, and one host sync per
    # phase), CUDA events, median of 5
    batch = make_prepare_batch(cfg.data.sigma, "cuda")(
        raw_batch(cfg, TRAIN["batch"]))
    step = make_train_step(system)
    lr = cfg.optim.lr
    scaled_ms = cuda_ms(lambda: step(batch, lr), iters=5, warmup=1)
    kept = system.scales
    system.scales = None
    try:
        plain_ms = cuda_ms(lambda: step(batch, lr), iters=5, warmup=1)
    finally:
        system.scales = kept
    rate = result.images_per_sec
    print(f"fp16 train slice: {steps} steps at batch {TRAIN['batch']}, "
          f"{rate} images/s after the first step "
          f"({TRAIN['batch'] / rate * 1e3:.3f} ms per step), overflow steps "
          f"{overflows}, final scales {scales}, peak device memory "
          f"{peak_gib:.2f} GiB, launches {launches}; one step by CUDA events "
          f"{scaled_ms:.3f} ms scaled, {plain_ms:.3f} ms with the scalers off")
    return launches


def same_state(got: dict, want: dict, where: str = "") -> int:
    """Every tensor of two state_dict trees equal, bit for bit; returns the
    count of tensors compared."""
    import torch

    check(type(got) is type(want), f"{where}: {type(got)} vs {type(want)}")
    if isinstance(want, dict):
        check(set(got) == set(want), f"{where}: keys differ")
        return sum(same_state(got[k], want[k], f"{where}.{k}") for k in want)
    if isinstance(want, torch.Tensor):
        check(got.shape == want.shape and got.dtype == want.dtype
              and torch.equal(got.cpu(), want.cpu()), f"{where} differs")
        return 1
    check(got == want, f"{where}: {got} vs {want}")
    return 0


def resume_phase(tmp: Path) -> dict:
    """Three flagship steps through scripts.train.main, a restore of the
    checkpoint they saved into a fresh system, three more through main with
    --continue_train; then the toy 3 + 3 resumed run against the 6-step run
    on the card.  Returns the kernels' launches in the two main runs."""
    import math
    import warnings

    import torch

    from mmhand_torch.scripts import train as train_script
    from mmhand_torch.train.state import build_system
    from mmhand_torch.utils.checkpoint import CheckpointManager

    ckpt_dir = tmp / "resume_ckpt"
    argv = ["--dataset", "synthetic", "--batchSize", str(TRAIN["batch"]),
            "--fineSize", str(FULL["size"]), "--max_steps", str(RESUME_STEPS),
            "--print_freq", "1", "--checkpoints_dir", str(ckpt_dir),
            "--name", "resume", "--device", "cuda"]
    first, out1, _, launches = _run_main(train_script.main, argv)
    cfg = first.system.config
    ckpt = CheckpointManager(str(ckpt_dir), "resume")
    path = Path(ckpt.path("latest"))
    check(path.exists() and first.system.step == RESUME_STEPS,
          "the first run saved no state_latest.pt")
    nbytes = path.stat().st_size
    saved = torch.load(path, map_location="cpu", weights_only=True)
    live = first.system.state_dict()
    own = live.pop("rank")
    same_state({k: saved[k] for k in live}, live, "saved")
    same_state({k: v[0] for k, v in saved["rank"].items()}, own, "saved rank")
    torch.cuda.synchronize()
    start = time.perf_counter()
    ckpt.save(first.system, "probe")
    save_s = time.perf_counter() - start
    del first, live, own
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fresh = build_system(cfg, "cuda")
    start = time.perf_counter()
    ckpt.restore(fresh, "latest")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - start
    got = fresh.state_dict()
    got["rank"] = {k: v[None] for k, v in got["rank"].items()}
    n_tensors = same_state(got, {k: v for k, v in saved.items()
                                 if k != "world"}, "restored")
    del fresh, got, saved

    second, out2, _, more = _run_main(
        train_script.main, argv + ["--continue_train"])
    check(second.steps == RESUME_STEPS
          and second.system.step == 2 * RESUME_STEPS,
          f"resumed run: {second.steps} steps, step {second.system.step}")
    check(all(math.isfinite(v) for v in second.last_metrics.values()),
          f"resumed metrics {second.last_metrics}")
    del second
    for k, v in more.items():
        launches[k] += v
    print(f"resume: state_latest.pt {nbytes} bytes, {n_tensors} tensors "
          f"restored bit for bit; save {save_s:.3f} s, restore {restore_s:.3f} "
          f"s; the resumed run reached step {2 * RESUME_STEPS}; launches "
          f"{launches}")
    toy_resume_check(tmp)
    return launches


def toy_config(pool_size: int, dropout: bool = True,
               padding: str = "reflect"):
    from mmhand_torch.config import (
        Config,
        DataConfig,
        ModelConfig,
        OptimConfig,
        PrecisionConfig,
    )

    return Config(model=ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=2,
                                    n_layers_d=2, use_dropout_g=dropout,
                                    use_dropout_d=dropout,
                                    padding_type=padding),
                  optim=OptimConfig(pool_size=pool_size),
                  data=DataConfig(dataset="synthetic", seed=SEED),
                  precision=PrecisionConfig(compute_dtype="float32"))


def toy_batches(n: int, batch: int, seed: int = SEED) -> list[dict]:
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    return [{k: torch.from_numpy(rng.uniform(-1, 1, (batch, 32, 32, c)
                                             ).astype(np.float32)).cuda()
             for k, c in (("H1", 3), ("P1", 21), ("D1", 3), ("H2", 3),
                          ("P2", 21), ("D2", 3))} for _ in range(n)]


def state_gap(a, b) -> tuple[bool, float]:
    """(every leaf equal, max |a - b| over the floating-point tensors) of two
    state trees of one structure."""
    import torch

    if isinstance(b, dict):
        gaps = [state_gap(a[k], b[k]) for k in b]
        return (all(g[0] for g in gaps), max([g[1] for g in gaps], default=0.0))
    if isinstance(b, (list, tuple)):
        gaps = [state_gap(x, y) for x, y in zip(a, b)]
        return (all(g[0] for g in gaps), max([g[1] for g in gaps], default=0.0))
    if isinstance(b, torch.Tensor):
        equal = torch.equal(a.cpu(), b.cpu())
        if b.is_floating_point() and b.numel():
            return equal, float((a.cpu().double() - b.cpu().double()).abs().max())
        return equal, 0.0
    return a == b, 0.0


def toy_resume_check(tmp: Path) -> None:
    """Toy size on the card, f32 with TF32 off, deterministic cuDNN and
    torch's deterministic algorithms (warn only), dropout and pools on: 3
    steps, a save, a fresh system restored, 3 more steps (resumed), against
    6 steps without a break, twice (unbroken).  The random streams and the
    step must match exactly; the rest must match bit for bit wherever two
    unbroken runs do, and else within nets_agree's bound.  Prints the ops
    torch names as having no deterministic CUDA implementation (the reflect
    pad's backward sums with atomics)."""
    import warnings

    import torch

    from mmhand_torch.train.state import build_system
    from mmhand_torch.train.step import make_train_step
    from mmhand_torch.utils.checkpoint import CheckpointManager

    batches = toy_batches(6, 2)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for padding in ("zero", "reflect"):
            cfg = toy_config(pool_size=4, padding=padding)
            lr = cfg.optim.lr
            ckpt = CheckpointManager(str(tmp / f"toy_{padding}"), "toy")
            with tf32_off(), warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                runs = []
                for _ in range(2):
                    system = build_system(cfg, "cuda")
                    step = make_train_step(system)
                    runs.append(([step(b, lr) for b in batches], system))
                system = build_system(cfg, "cuda")
                step = make_train_step(system)
                metrics = [step(b, lr) for b in batches[:3]]
                ckpt.save(system, "latest")
                system = build_system(cfg, "cuda")
                ckpt.restore(system, "latest")
                step = make_train_step(system)
                metrics += [step(b, lr) for b in batches[3:]]
            nondeterministic = sorted({
                str(w.message).split(" does not have")[0] for w in caught
                if "deterministic implementation" in str(w.message)})
            (want, unbroken), (again, twice) = runs
            rest = unbroken.state_dict()
            got = system.state_dict()
            check(got["step"] == rest["step"], "toy resume: step")
            for key in ("rng_pool", "rng_cuda", "rng_cpu"):
                check(torch.equal(got["rank"][key], rest["rank"][key]),
                      f"toy resume {padding}: the {key} stream differs")
            same, gap = state_gap((metrics, got), (want, rest))
            same2, gap2 = state_gap((again, twice.state_dict()), (want, rest))
            if same2:
                check(same, f"toy resume {padding}: two unbroken runs agree bit "
                            f"for bit, the resumed one differs by {gap}")
            for m, w in zip(metrics, want):
                for k, v in w.items():
                    check(abs(float(m[k]) - float(v)) <= 2e-4 * (1 + abs(float(v))),
                          f"toy resume {padding}: loss {k}")
            summary = nets_agree(system, unbroken, 6, lr)
            print(f"toy resume on the card ({padding} padding; f32, TF32 off, "
                  f"deterministic algorithms, dropout, pool 4): resumed "
                  f"against unbroken: bit for bit {same}, max |diff| {gap} "
                  f"({summary}); unbroken against unbroken: bit for bit "
                  f"{same2}, max |diff| {gap2}; ops without a deterministic "
                  f"CUDA implementation: {nondeterministic}")
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def dp_worker(out: str) -> None:
    """One rank of a torchrun launch on the card (NCCL): 3 flagship steps
    through ``train(distributed=True)``, then one step timed by CUDA events
    and its all-reduces counted; rank 0 writes the JSON ``out``."""
    import warnings

    import torch.distributed as dist

    from mmhand_torch.data import make_prepare_batch
    from mmhand_torch.parallel import init_distributed
    from mmhand_torch.parallel.sharding import collective_launches
    from mmhand_torch.train.loop import train
    from mmhand_torch.train.step import make_train_step

    device = init_distributed("cuda")
    try:
        cfg = flagship_config(Path(out).parent / "nccl_ckpt", "nccl")
        counters = kernel_counters()
        for f in counters.values():
            f.launches = 0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            result = train(cfg, device=device, max_steps=RESUME_STEPS,
                           distributed=True)
        launches = {k: f.launches for k, f in counters.items()}
        batch = make_prepare_batch(cfg.data.sigma, device)(
            raw_batch(cfg, cfg.data.batch_size // dist.get_world_size()))
        step = make_train_step(result.system)
        lr = cfg.optim.lr
        ms = cuda_ms(lambda: step(batch, lr), iters=5, warmup=1)
        before = collective_launches()
        step(batch, lr)
        per_step = collective_launches() - before
        if dist.get_rank() == 0:
            Path(out).write_text(json.dumps({
                "steps": result.steps, "metrics": result.last_metrics,
                "images_per_sec": result.images_per_sec, "step_ms": ms,
                "all_reduces_per_step": per_step, "launches": launches,
                "world": dist.get_world_size(),
                "finite": nets_finite(result.system)}))
    finally:
        dist.destroy_process_group()


def nccl_phase(tmp: Path, single_step_ms: float) -> dict:
    """The flagship DP path at world size 1 over NCCL, launched by
    torch.distributed.run; returns its kernels' launches."""
    import math

    out = tmp / "nccl.json"
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", str(ROOT / "chip_smoke.py"), "--dp-worker",
         str(out)], capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - start
    check(proc.returncode == 0 and out.exists(),
          f"torchrun worker failed ({proc.returncode}):\n{proc.stdout[-3000:]}"
          f"\n{proc.stderr[-3000:]}")
    r = json.loads(out.read_text())
    launches = r["launches"]
    check(r["steps"] == RESUME_STEPS and r["finite"]
          and all(math.isfinite(v) for v in r["metrics"].values()),
          f"NCCL world 1: {r}")
    check(launches["bn_sums"] == BN_PER_STEP * RESUME_STEPS
          and launches["bn_sums_backward"] == BN_PER_STEP * RESUME_STEPS,
          f"NCCL world 1 launches {launches}")
    print(f"NCCL world size 1 (torchrun, {seconds:.1f} s with start-up): "
          f"{RESUME_STEPS} flagship steps, {r['images_per_sec']} images/s after "
          f"the first; one step {r['step_ms']:.3f} ms by CUDA events against "
          f"{single_step_ms:.3f} ms single-process; {r['all_reduces_per_step']} "
          f"all-reduces per step; launches {launches}")
    return launches


def gloo_worker(out: str) -> None:
    """One of two ranks on the one card over gloo: one toy DP step (f32,
    TF32 off, dropout off, pool 0) on this rank's half of the batch; rank 0
    saves the three nets and the metrics."""
    import warnings

    import torch
    import torch.distributed as dist

    from mmhand_torch.parallel import init_distributed
    from mmhand_torch.train.state import build_system
    from mmhand_torch.train.step import make_train_step

    init_distributed("cpu")  # gloo, with the tensors on the card
    try:
        rank = dist.get_rank()
        cfg = toy_config(pool_size=0, dropout=False)
        counters = kernel_counters()
        with tf32_off(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            system = build_system(cfg, "cuda", distributed=True)
            for f in counters.values():
                f.launches = 0
            full = toy_batches(1, 4)[0]
            metrics = make_train_step(system)(
                {k: v[2 * rank:2 * rank + 2] for k, v in full.items()},
                cfg.optim.lr)
        if rank == 0:
            torch.save({"nets": {n: getattr(system, n).state_dict()
                                 for n in ("generator", "d_pb", "d_pp")},
                        "metrics": {k: float(v) for k, v in metrics.items()},
                        "launches": {k: f.launches
                                     for k, f in counters.items()}}, out)
    finally:
        dist.destroy_process_group()


def gloo_phase(tmp: Path) -> dict:
    """Two ranks on the one card over gloo, one toy DP step, against the
    single-process step on the full batch on the card; returns rank 0's
    kernel launches."""
    import warnings

    import torch

    from mmhand_torch.parallel.dryrun import launch
    from mmhand_torch.train.state import build_system
    from mmhand_torch.train.step import make_train_step

    out = tmp / "gloo.pt"
    start = time.perf_counter()
    launch([str(ROOT / "chip_smoke.py"), "--gloo-worker", str(out)], 2,
           timeout=300)
    seconds = time.perf_counter() - start
    r = torch.load(out, weights_only=True)
    cfg = toy_config(pool_size=0, dropout=False)
    with tf32_off(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        single = build_system(cfg, "cuda")
        want = make_train_step(single)(toy_batches(1, 4)[0], cfg.optim.lr)
        dp = build_system(cfg, "cpu")
    for name, sd in r["nets"].items():
        getattr(dp, name).load_state_dict(sd)
    for k, v in want.items():
        check(abs(r["metrics"][k] - float(v)) <= 2e-4 * (1 + abs(float(v))),
              f"gloo DP loss {k}: {r['metrics'][k]} against {float(v)}")
    summary = nets_agree(dp, single, 1, cfg.optim.lr)
    print(f"two ranks on the card over gloo ({seconds:.1f} s with start-up): "
          f"one toy DP step against the full-batch step: {summary}; rank 0 "
          f"launches {r['launches']}")
    return r["launches"]


def jointsmap_case(name: str, batch: int, height: int, width: int):
    """Hand-sized poses (uv, z on the CPU) or one of the edge cases of
    tests/test_torch_cuda.py: crossing bones (occlusion), equal depths
    (ties), zero-length bones, joints parked off the frame; then the cull's
    degenerate cases: bones of length 1e-7 and 5e-7 (tiny), half_len at its
    1e-3 floor (floor), NaN keypoints and depths (nan), long bones crossing
    the frame (long), ellipses touching the warp tiles' edges (graze)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(SEED)
    scale = np.array([width, height], np.float32)
    uv = ((rng.uniform(0.3, 0.7, (batch, 1, 2))
           + rng.normal(0, 0.18, (batch, 21, 2))) * scale).astype(np.float32)
    z = (rng.uniform(300, 700, (batch, 21)) / 700 * 255).astype(np.float32)
    if name == "occlusion":
        uv[:] = -500.0
        z[:] = 1.0e6
        uv[:, 1], uv[:, 2] = [20, 128], [236, 128]
        uv[:, 5], uv[:, 6] = [128, 20], [128, 236]
        z[:, [1, 2]], z[:, [5, 6]] = 0.2, 0.8
    elif name == "tie":
        z[:] = 100.0
    elif name == "zero_length":
        uv[:, 2] = uv[:, 1]
        uv[:, 18] = uv[:, 19] = uv[:, 20] = uv[:, 17]
    elif name == "parked":
        uv[:, 5:] = [-1000.0, 4000.0]
    elif name == "tiny":
        uv[:, 1], uv[:, 2] = [1e-7, 0.0], [0.0, 0.0]
        uv[:, 5], uv[:, 6] = [2e-7, 3e-7], [5e-7, -1e-7]
        z[:, [1, 2, 5, 6]] = 50.0
    elif name == "floor":
        uv[:, 9] = [width / 2, height / 2]
        uv[:, 10] = uv[:, 9] + [1e-3, 0.0]
        uv[:, 14] = [width / 4 + 0.5, height / 4]
        uv[:, 15] = uv[:, 14] + [0.0, 2e-3]
        z[:, [9, 10, 14, 15]] = 10.0
    elif name == "nan":
        uv[:, 3] = np.nan
        uv[:, 7, 0] = np.nan
        z[:, 12] = np.nan
    elif name == "long":
        uv[:, 17], uv[:, 18] = [-3000.0, 0.2 * height], [3000.0, 0.85 * height]
        uv[:, 13], uv[:, 14] = [0.5 * width, -4000.0], [0.4 * width, 4000.0]
        z[:, [13, 14, 17, 18]] = 20.0
    elif name == "graze":
        uv[:, 1], uv[:, 2] = [16.0, 40.0], [32.0, 40.0]
        uv[:, 5], uv[:, 6] = [70.0, 24.0], [70.0, 48.0]
        uv[:, 9], uv[:, 10] = [100.0, 35.0], [120.0, 35.0]
        uv[:, 13], uv[:, 14] = [44.0, 60.0], [60.0, 76.0]
        z[:, [1, 2, 5, 6, 9, 10, 13, 14]] = 30.0
    return torch.from_numpy(uv), torch.from_numpy(z)


def jointsmap_pairs(uv, z, height: int, width: int) -> tuple[int, int, int]:
    """K3's (pixel, bone) pairs on these inputs: all of them, those whose
    pixel its bone's rectangle does not rule out (what the inputs need), and
    those the kernel's warp tiles run (not culled)."""
    import torch

    from mmhand_torch.ops.jointsmap import (
        CULL_TILE,
        HAND_BONES,
        bone_params,
        culled_tiles,
        outside_rectangle,
    )

    params = tuple(p[..., None, None] for p in bone_params(uv, z))
    rows = torch.arange(height, dtype=torch.float32)[:, None]
    cols = torch.arange(width, dtype=torch.float32)
    near = ~outside_rectangle(params, cols, rows, 0.0, 0.0)
    th, tw = CULL_TILE
    live = ~culled_tiles(uv, z, height, width)
    run = live.repeat_interleave(th, -2).repeat_interleave(tw, -1)
    return (uv.shape[0] * len(HAND_BONES) * height * width, int(near.sum()),
            int(run[..., :height, :width].sum()))


def kernel_device_ms(fn, names: tuple[str, ...], calls: int = 20) -> float:
    """Device milliseconds of one call of ``fn`` spent in the kernels whose
    names contain one of ``names``, from torch.profiler over ``calls``
    calls: the kernels alone, without the wrapper's host work that CUDA
    events around a call also see.  NaN when the trace holds no device time
    (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_trace_start()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0.0)
             for ev in prof.key_averages()
             if any(name in ev.key for name in names))
    return us / 1e3 / calls if us else float("nan")


def jointsmap_kernel_phase():
    """K3 against generate_jointsmap_ref run on the CPU, bit for bit (the
    plain version on the card multiplies by 1/5 where K3 and the CPU divide
    by 5), on poses, edge and degenerate cases and the baselines' poses;
    returns its record, at the baselines' batch."""
    import numpy as np
    import torch

    from mmhand_torch.config import Config, DataConfig, ModelConfig
    from mmhand_torch.ops.jointsmap import generate_jointsmap, generate_jointsmap_ref

    size, nb = FULL["size"], EVAL["baseline_batch"]
    cfg = Config(model=ModelConfig(fine_size=size),
                 data=DataConfig(dataset="synthetic"), is_train=False)
    raw = raw_batch(cfg, nb)
    # bench_baselines.jointsmap_condition's inputs
    main = (torch.from_numpy(raw["tgt_uv"]),
            torch.from_numpy((np.asarray(raw["tgt_z"]) / 700.0 * 255.0
                              ).astype(np.float32)))
    record = {}
    for name, batch, height, width in [("main path", nb, size, size)] + K3_SHAPES:
        if name == "main path":
            uv, z = main
        else:
            uv, z = jointsmap_case(name, batch, height, width)
        uv_d, z_d = uv.cuda(), z.cuda()
        got = generate_jointsmap(uv_d, z_d, height, width)
        torch.cuda.synchronize()
        want = generate_jointsmap_ref(uv, z, height, width)
        check(got.shape == want.shape == (batch, height, width),
              f"K3 shape {tuple(got.shape)}")
        err = float((got.cpu() - want).abs().max())
        check(err == 0.0, f"K3 {name} ({batch}, {height}, {width}) differs "
                          f"from the plain version on the CPU by {err}")
        on_card = generate_jointsmap_ref(uv_d, z_d, height, width).cpu()
        flipped = int((on_card != want).sum())
        pairs, near, run = jointsmap_pairs(uv, z, height, width)
        line = (f"K3 generate_jointsmap {name} ({batch}, {height}, {width}): "
                f"max_abs_err 0.0 against the CPU; the plain version on the "
                f"card differs at {flipped} pixels; pairs {pairs}, not ruled "
                f"out pixel by pixel {near}, run by the warp tiles {run} "
                f"(skipped {1 - run / pairs:.4f})")
        if name in ("main path", "poses") and height == size and batch == nb:
            ms = cuda_ms(lambda: generate_jointsmap(uv_d, z_d, height, width))
            device_ms = kernel_device_ms(
                lambda: generate_jointsmap(uv_d, z_d, height, width),
                K3_KERNELS)
            plain_ms = cuda_ms(
                lambda: generate_jointsmap_ref(uv_d, z_d, height, width))
            io_bytes = got.numel() * 4 + uv.numel() * 4 + z.numel() * 4
            # the exact test's 16 f32 operations, for the pairs whose pixel
            # the bone's rectangle does not rule out; beside it, all pairs
            k3_bound, k3_by = bound(io_bytes, K3_OPS_PER_PIXEL_BONE * near)
            all_bound, _ = bound(io_bytes, K3_OPS_PER_PIXEL_BONE * pairs)
            wrapper_us = host_us(
                lambda: generate_jointsmap(uv_d[:1], z_d[:1], 8, 8))
            line += (f"; kernel {ms:.4f} ms per call ({device_ms:.4f} ms of "
                     f"device time, profiler; the wrapper's host work "
                     f"{wrapper_us:.1f} us per call at (1, 8, 8)), plain "
                     f"{plain_ms:.4f} ms, bound "
                     f"{k3_bound:.4f} ms ({k3_by}; {all_bound:.4f} ms for all "
                     f"pairs); no single PyTorch call computes the same "
                     f"function")
            if name == "main path":
                skipped_share = 1 - run / pairs
            else:
                record = {"name": "generate_jointsmap", "route": "cuda",
                          "source": "mmhand_torch/csrc/jointsmap.cu",
                          "replaces": K3_REPLACES, "max_abs_err": err,
                          "max_rel_err": None, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": k3_bound, "bound_by": k3_by,
                          "library_ms": None, "device_ms": device_ms,
                          "skipped_share": skipped_share}
        print(line)
    return record


def small_eval_phase():
    """The evaluation modules on the card against the CPU at batch 2, in
    float32 with TF32 off: the conditioning image (bit for bit), Inception
    logits and pool features, per-image SSIM, Hpm2d heatmaps and Hpm3d z."""
    import warnings

    import numpy as np
    import torch

    from mmhand_torch.eval import Evaluator, HPEJudge
    from mmhand_torch.eval.evaluator import full_fp32

    size = FULL["size"]
    uv, z = jointsmap_case("poses", 2, size, size)
    xyz = torch.cat([uv, z[..., None]], -1)
    cond = Evaluator.create_input_image(xyz.cuda(), size)
    check(torch.equal(cond.cpu(), Evaluator.create_input_image(xyz, size)),
          "create_input_image on the card differs from the CPU")

    judge_size = 128  # the CPM nets at 256 px take seconds on the host
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-weights warnings
        on_cpu = Evaluator(judge=HPEJudge.random_init(judge_size, device="cpu"),
                           device="cpu")
        on_card = Evaluator(judge=HPEJudge.random_init(judge_size, device="cuda"),
                            device="cuda")
    rng = np.random.RandomState(SEED)
    gt = torch.from_numpy(rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32))
    pred = (gt * 0.8 + 0.1).contiguous()
    errs = {}
    for part, a, b in zip(("logits", "pool"),
                          on_card.inception_forward(pred.cuda()),
                          on_cpu.inception_forward(pred)):
        errs[part] = float((a.cpu() - b).abs().max() / (b.abs().max() + 1e-12))
    errs["ssim"] = float((on_card.ssim_forward(pred.cuda(), gt.cuda()).cpu()
                          - on_cpu.ssim_forward(pred, gt)).abs().max())
    small = pred[:, ::2, ::2].contiguous()
    with full_fp32():
        heat_card = on_card.judge.hpm2d(small.cuda())
        heat_cpu = on_cpu.judge.hpm2d(small)
        z_card = on_card.judge.hpm3d(heat_cpu[-1].cuda())
        z_cpu = on_cpu.judge.hpm3d(heat_cpu[-1])
    errs["heatmaps"] = max(float((a.cpu() - b).abs().max() / b.abs().max())
                           for a, b in zip(heat_card, heat_cpu))
    errs["z"] = float((z_card.cpu() - z_cpu).abs().max() / z_cpu.abs().max())
    # f32 with TF32 off, conv taps summed in another order: 1e-4 of the
    # largest value; SSIM absolute
    check(all(v <= 1e-4 for k, v in errs.items() if k != "ssim")
          and errs["ssim"] <= 1e-5, f"eval modules card vs CPU: {errs}")
    print("small eval reference (batch 2, f32, TF32 off): create_input_image "
          "bit for bit; relative errors "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))


def _run_main(fn, argv):
    """``fn(argv)`` with the kernels' counts set to 0 just before and read
    just after; returns (its result, its stdout, seconds, launches)."""
    import warnings

    import torch

    counted = kernel_counters()
    out = io.StringIO()
    for f in counted.values():
        f.launches = 0
    start = time.perf_counter()
    with warnings.catch_warnings(), contextlib.redirect_stdout(out):
        warnings.simplefilter("ignore")  # random Inception/CPM/baseline weights
        result = fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {k: f.launches for k, f in counted.items()}
    return result, out.getvalue().strip(), seconds, launches


def _check_scores(what: str, scores: dict, n_items: int) -> None:
    import math

    keys = ("IS_avg", "IS_std", "SSIM_avg", "SSIM_std", "pck2d_auc",
            "pck3d_auc", "fid", "images_per_sec", "images_per_sec_steady")
    check(all(k in scores and math.isfinite(scores[k]) for k in keys),
          f"{what}: scores {scores}")
    check(scores["images"] == n_items, f"{what}: {scores['images']} images")
    check(scores["weights"] == "random:inception+cpm",
          f"{what}: weights {scores['weights']}")


def eval_slice_phase(tmp: Path) -> dict:
    """The full-width evaluation path: evaluate_gan over the train phase's
    generator, then bench_baselines with both jointsmap-conditioned
    baselines; returns the kernels' launches over the three runs."""
    import warnings

    import numpy as np
    import torch

    from mmhand_torch.config import Config, DataConfig, ModelConfig
    from mmhand_torch.data import make_prepare_batch
    from mmhand_torch.eval.evaluator import full_fp32
    from mmhand_torch.models.inception import inception_preprocess
    from mmhand_torch.scripts import bench_baselines, evaluate_gan
    from mmhand_torch.train.state import build_generator
    from mmhand_torch.train.step import make_eval_step
    from mmhand_torch.utils.checkpoint import load_state_dict, network_path

    size, n_items = FULL["size"], EVAL["n_items"]
    common = ["--dataset", "synthetic", "--fineSize", str(size),
              "--max_dataset_size", str(n_items), "--device", "cuda"]
    ckpt = tmp / "train_ckpt"
    total: dict[str, int] = {}
    runs = [("evaluate_gan", evaluate_gan.main,
             common + ["--eval_batch", str(EVAL["gan_batch"]),
                       "--checkpoints_dir", str(ckpt), "--name", "train_smoke"],
             EVAL["gan_batch"])]
    for arch in ("resnet", "unet"):
        runs.append((f"bench_baselines {arch}", bench_baselines.main,
                     common + ["--arch", arch, "--ngf", str(FULL["ngf"]),
                               "--eval_batch", str(EVAL["baseline_batch"])],
                     EVAL["baseline_batch"]))
    for what, fn, argv, batch in runs:
        torch.cuda.reset_peak_memory_stats()
        scores, out, seconds, launches = _run_main(fn, argv)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        print(out.splitlines()[-1])
        _check_scores(what, scores, n_items)
        batches = -(-n_items // batch)
        k3_want = batches if what.startswith("bench") else 0
        check(launches["generate_jointsmap"] == k3_want
              and launches["gaussian_heatmaps"] == 2 * batches
              and launches["bn_sums"] == launches["bn_sums_backward"] == 0,
              f"{what}: launches {launches}")
        print(f"{what}: {n_items} images at batch {batch} in {seconds:.3f} s "
              f"(FID's 2048-d sqrtm on the host included), "
              f"{scores['images_per_sec_steady']} images/s after the first "
              f"batch, peak device memory {peak_gib:.2f} GiB, launches "
              f"{launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # where one batch's time goes, one part at a time (CUDA events)
    cfg = Config(model=ModelConfig(fine_size=size, ngf=FULL["ngf"]),
                 data=DataConfig(dataset="synthetic", seed=49), is_train=False)
    raw = raw_batch(cfg, EVAL["gan_batch"])
    batch = make_prepare_batch(cfg.data.sigma, "cuda")(raw)
    generator = build_generator(cfg, "cuda")
    generator.load_state_dict(load_state_dict(network_path(str(ckpt),
                                                           "train_smoke")))
    eval_step = make_eval_step(generator)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        evaluator = evaluate_gan.build_evaluator(size, "cuda")
        baselines = {arch: bench_baselines.build_baseline(cfg, arch, "cuda")
                     for arch in ("resnet", "unet")}
    fakes, gt = eval_step(batch), batch["H2"]
    judge = evaluator.judge

    def judge_nets():
        return judge.hpm3d(judge.hpm2d(fakes)[-1])

    times = {
        "MM-Hand G (16)": cuda_ms(lambda: eval_step(batch), iters=5),
        "Inception (16)": cuda_ms(lambda: evaluator.inception_forward(fakes),
                                  iters=5),
        "SSIM (16)": cuda_ms(lambda: evaluator.ssim_forward(fakes, gt), iters=5),
        "judge (16)": cuda_ms(lambda: judge.predict(fakes), iters=5),
    }
    with full_fp32():
        times["judge nets (16)"] = cuda_ms(judge_nets, iters=5)
    # what TF32 off costs: the same forwards with cuDNN's default TF32
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            times["Inception TF32 (16)"] = cuda_ms(
                lambda: evaluator.inception(inception_preprocess(fakes)),
                iters=5)
            times["judge nets TF32 (16)"] = cuda_ms(judge_nets, iters=5)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    nb = EVAL["baseline_batch"]
    pose = {"tgt_uv": raw["tgt_uv"][:nb], "tgt_z": raw["tgt_z"][:nb]}
    xyz = np.concatenate([pose["tgt_uv"], pose["tgt_z"][:, :, None]], -1)
    cond = bench_baselines.jointsmap_condition(pose, size, "cuda")
    times["K3 + normalize (8)"] = cuda_ms(
        lambda: bench_baselines.jointsmap_condition(pose, size, "cuda"),
        iters=10)
    with torch.inference_mode():
        for arch, net in baselines.items():
            times[f"{arch} G (8)"] = cuda_ms(lambda: net(cond), iters=5)
    evaluator.feed(fakes, gt, np.concatenate(
        [raw["tgt_uv"], raw["tgt_z"][:, :, None]], -1))
    start = time.perf_counter()
    evaluator.evaluate()  # FID of 16 + the chunked IS, on the host
    times["scores on the host (16)"] = (time.perf_counter() - start) * 1e3
    print("eval batch parts (CUDA events, median, ms; the host scores by "
          "host clock): " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))

    def one_baseline_batch():
        with torch.inference_mode():
            out = baselines["unet"](
                bench_baselines.jointsmap_condition(pose, size, "cuda"))
        evaluator.feed(out, gt[:nb], xyz)

    print(profile_step(one_baseline_batch, "unet baseline batch of 8",
                       {"K3": K3_KERNELS})[0])
    return total


def hpe_step_flops(system, batch) -> float:
    """Floating-point operations of one HPE step's convolutions and linear
    layers: 2 x the multiply-adds of each net's forward on this batch,
    counted from the layers' shapes by hooks, times 3 (the backward forms
    the input's and the weights' gradients, each as many)."""
    import torch
    from torch import nn

    total = [0]

    def count(module, args, out):
        if isinstance(module, nn.Conv2d):
            k = module.in_channels // module.groups * math.prod(
                module.kernel_size)
        else:
            k = module.in_features
        total[0] += 2 * out.numel() * k

    nets = (system.hpm2d, system.hpm3d)
    hooks = [m.register_forward_hook(count) for net in nets
             for m in net.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad(), system.autocast():
            system.hpm2d(batch["image"])
            system.hpm3d(batch["heatmaps"])
    finally:
        for h in hooks:
            h.remove()
    return 3.0 * total[0]


def hpe_train_phase(tmp: Path) -> tuple[dict, Path]:
    """The HPE path at full width through scripts.train_hpe.main on an
    RHD-layout tree (--model hpm, batch 32, 256 px, bf16): losses, nets
    moved, K1 at sigma 5 on the batch's keypoints, one step's time, rate,
    FLOP share and profile.  Returns the kernels' launches in the run and
    the tree."""
    import torch

    from mmhand_torch.data.rhd_tree import write_rhd_tree
    from mmhand_torch.hpe import (
        HPEMixDataset,
        HPESystem,
        make_hpe_prepare_batch,
        make_hpe_train_step,
    )
    from mmhand_torch.ops.heatmap import gaussian_heatmaps, gaussian_heatmaps_ref
    from mmhand_torch.scripts import train_hpe
    from mmhand_torch.utils.checkpoint import CheckpointManager

    size, batch_size, steps = FULL["size"], HPE["batch"], HPE["steps"]
    start = time.perf_counter()
    tree = Path(write_rhd_tree(tmp / "rhd_train", HPE["n_items"], size,
                               SEED))
    print(f"HPE tree: {HPE['n_items']} images at {size} px written in "
          f"{time.perf_counter() - start:.3f} s")
    argv = ["--dataset", "RHD", "--dataroot", str(tree), "--model", "hpm",
            "--batchSize", str(batch_size), "--fineSize", str(size),
            "--max_steps", str(steps), "--print_freq", "1",
            "--checkpoints_dir", str(tmp / "hpe_ckpt"), "--name", "hpe_smoke",
            "--device", "cuda",
            # no epoch saves inside the run (2 steps per epoch): the loop's
            # rate is then the steps' and the data's; a save is timed below
            "--save_epoch_freq", "10"]
    torch.cuda.reset_peak_memory_stats()
    result, out, seconds, launches = _run_main(train_hpe.main, argv)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(out)
    system, cfg = result.system, result.system.config
    check(cfg.precision.compute_dtype == "bfloat16" and system.variant == "hpm"
          and cfg.data.augmentation_ratio == 1.0, "HPE config")
    check(result.steps == steps, f"HPE: {result.steps} steps")
    check(launches == {"gaussian_heatmaps": steps, "bn_sums": 0,
                       "bn_sums_backward": 0, "generate_jointsmap": 0},
          f"HPE launches {launches}")
    lines = re.findall(r"\(epoch: \d+, iters: (\d+), time: [^)]*\) (.*)", out)
    check(len(lines) == steps, f"{len(lines)} HPE loss lines")
    for it, rest in lines:
        values = dict(re.findall(r"(\w+): (\S+)", rest))
        check(set(values) == {"mse", "lz"}
              and all(math.isfinite(float(v)) for v in values.values()),
              f"HPE step {it} losses {values}")
    # every parameter has a gradient from the last step, and every weight
    # moved but one whose last gradient lies below Adam's eps everywhere:
    # with flax's lecun-normal init, Hpm3d's chain of CPM stages passes
    # back gradients far below it, and Adam's update lr * g / (|g| + eps)
    # then leaves the f32 weights as they were (so in mmhand_tpu too)
    init = HPESystem(cfg, "hpm", "cpu")
    for name, opt in (("hpm2d", system.opt2d), ("hpm3d", system.opt3d)):
        eps = opt.defaults["eps"]
        params = dict(getattr(system, name).named_parameters())
        no_grad = [k for k, p in params.items() if p.grad is None]
        check(not no_grad, f"HPE {name}: no gradient for {no_grad[:4]}")
        still = {k: float(params[k].grad.abs().max())
                 for k, v in getattr(init, name).state_dict().items()
                 if k.endswith("weight")
                 and torch.equal(params[k].detach().cpu(), v)}
        stuck = {k: g for k, g in still.items() if g >= eps}
        check(not stuck, f"HPE {name}: {sorted(stuck.items())[:4]} did not "
              f"move, their gradients not below eps {eps}")
        print(f"HPE {name}: {len(params)} parameters; {len(still)} weights "
              f"did not move, their last gradients at most "
              f"{max(still.values(), default=0.0):.3e} (eps {eps})")
    check((tmp / "hpe_ckpt" / "hpe_smoke" / "state_latest.pt").exists(),
          "HPE state_latest.pt not written")

    # the host's share of a loop step: one batch read (PIL decode of 32
    # PNGs), host clock; and one save of the whole train state
    dataset = HPEMixDataset(cfg)
    start = time.perf_counter()
    raw = dataset.batch(range(batch_size))
    read_ms = (time.perf_counter() - start) * 1e3
    ckpt = CheckpointManager(str(tmp / "hpe_ckpt"), "hpe_smoke")
    start = time.perf_counter()
    ckpt.save(system, "timed")
    save_s = time.perf_counter() - start
    state_bytes = Path(ckpt.path("timed")).stat().st_size

    # K1 at sigma 5 on the HPE path's keypoints, at its shape
    uv = torch.from_numpy(raw["uv"]).cuda()
    err, exempt, skipped = check_heatmaps(uv, size, size, 5.0, "HPE batch")
    k1_ms = cuda_ms(lambda: gaussian_heatmaps(uv, size, size, 5.0))
    k1_device = kernel_device_ms(
        lambda: gaussian_heatmaps(uv, size, size, 5.0), K1_KERNELS)
    k1_plain = cuda_ms(lambda: gaussian_heatmaps_ref(uv, size, size, 5.0))
    k1_bound, k1_by = bound(batch_size * size * size * 21 * 4 + uv.numel() * 4,
                            9 * (1 - skipped) * batch_size * size * size * 21)
    print(f"K1 sigma 5 on the HPE batch ({batch_size}, {size}, {size}, 21): "
          f"max_abs_err {err} ({exempt} exempt) against gaussian_heatmaps_ref; "
          f"early-out skips {skipped:.4f}; kernel {k1_ms:.4f} ms per call "
          f"({k1_device:.4f} ms of device time), plain {k1_plain:.4f} ms, "
          f"bound {k1_bound:.4f} ms ({k1_by})")

    # one step, CUDA events, median of the steady steps after warm-up
    step = make_hpe_train_step(system)
    prepare = make_hpe_prepare_batch(device="cuda")
    batch = prepare(raw)
    lr = cfg.optim.lr
    prep_ms = cuda_ms(lambda: prepare(raw), iters=5, warmup=1)
    step_ms = cuda_ms(lambda: step(batch, lr), iters=5, warmup=1)
    flops = hpe_step_flops(system, batch)
    report, _ = profile_step(lambda: step(prepare(raw), lr),
                             "HPE prepare + step", {"K1": K1_KERNELS})
    print(report)
    rate = result.images_per_sec
    check(rate is not None and rate > 0, "train_hpe printed no steady rate")
    print(f"HPE train: {steps} steps at batch {batch_size} in {seconds:.3f} s "
          f"(build and cuDNN warm-up included), {rate} images/s in the loop "
          f"after the first step; one step {step_ms:.3f} ms (CUDA events, "
          f"median of 5), {batch_size / step_ms * 1e3:.2f} images/s, prepare "
          f"{prep_ms:.3f} ms; {flops / 1e12:.3f} TFLOP per step (convolutions "
          f"and linear layers, 3 x forward), {flops / step_ms / 1e9:.1f} "
          f"TFLOP/s, {100 * flops / step_ms / 1e-3 / BF16_FLOPS:.1f}% of the "
          f"bf16 dense peak; peak device memory {peak_gib:.2f} GiB; launches "
          f"{launches}")
    print(f"HPE host work per loop step: batch read {read_ms:.3f} ms (PIL "
          f"decode of {batch_size} PNGs, host clock); state_<label>.pt "
          f"{state_bytes} bytes, saved in {save_s:.3f} s (each "
          f"--save_epoch_freq epoch saves it twice)")
    return launches, tree


def hpe_test_phase(tmp: Path, tree: Path) -> dict:
    """scripts.test_hpe.main on the HPE train phase's checkpoint, --model
    hpm and hpm3d, over the tree; the scores must be finite (random
    weights, so they are structural only).  Returns K1's launches."""
    import torch

    from mmhand_torch.scripts import test_hpe

    total: dict[str, int] = {}
    common = ["--dataset", "RHD", "--dataroot", str(tree), "--fineSize",
              str(FULL["size"]), "--eval_batch", str(HPE["eval_batch"]),
              "--checkpoints_dir", str(tmp / "hpe_ckpt"), "--name",
              "hpe_smoke", "--device", "cuda"]
    batches = HPE["n_items"] // HPE["eval_batch"]
    for model, blocks, k1 in (("hpm", {"2d", "3d"}, 0),
                              ("hpm3d", {"3d_z"}, batches)):
        torch.cuda.reset_peak_memory_stats()
        results, out, seconds, launches = _run_main(
            test_hpe.main, common + ["--model", model])
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        check(set(results) == blocks
              and all(math.isfinite(v) for r in results.values()
                      for v in r.values()), f"test_hpe {model}: {results}")
        check(launches["gaussian_heatmaps"] == k1
              and launches["generate_jointsmap"] == 0,
              f"test_hpe {model}: launches {launches}")
        print(f"test_hpe --model {model}: {HPE['n_items']} images in "
              f"{seconds:.3f} s, peak device memory {peak_gib:.2f} GiB, "
              f"launches {launches}; {results} (random weights: structural "
              f"only)")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def ratio_driver_phase(tmp: Path, tree: Path) -> None:
    """mmhand_torch.scripts.mm_train_ratio on the card at ratios 0.5 and
    1.0 over the tree: the flagship GAN for one epoch at batch 32 (1 and 2
    steps), aug into {method}_{leaf}, the HPE for one epoch (2 steps) and
    test_hpe; every stage must exit 0, the augmentation dir must hold
    exactly the images HPEMixDataset marks, and every score be finite."""
    from mmhand_torch.config import Config, DataConfig, ModelConfig
    from mmhand_torch.hpe.data import HPEMixDataset, augmentation_dir_for

    cmd = [sys.executable, "-m", "mmhand_torch.scripts.mm_train_ratio",
           "--dataset", "RHD", "--dataroot", str(tree),
           "--test_dataroot", str(tree), "--ratios", "0.5", "1.0",
           "--batchSize", str(HPE["batch"]), "--niter", "1",
           "--hpe_epochs", "1", "--device", "cuda",
           "--checkpoints_dir", str(tmp / "ratio_ckpt"),
           "--extra_gan_args", "--niter_decay", "0"]
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()  # the stages need the card's memory
    start = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True,
                          timeout=900)
    seconds = time.perf_counter() - start
    out = proc.stdout
    check(proc.returncode == 0, f"the ratio driver exited {proc.returncode}:"
          f"\n{out[-3000:]}\n{proc.stderr[-3000:]}")
    print("\n".join(line for line in out.splitlines()
                    if line.startswith(("+ ", "done:", "wrote "))))
    stages = re.findall(r"^\+ \S+ -m mmhand_torch\.scripts\.(\w+) ", out, re.M)
    check(stages == ["train", "aug", "train_hpe", "test_hpe", "train",
                     "train_hpe", "test_hpe"], f"driver stages {stages}")
    gan = re.findall(r"^done: (\d+) steps.*, last metrics", out, re.M)
    hpe = re.findall(r"^done: (\d+) steps, mse=\S+ lz=\S+; ([0-9.]+) "
                     r"images/s after the first step; (\d+) augmented", out,
                     re.M)
    n_aug = HPE["n_items"] // 2
    check([int(g) for g in gan] == [1, 2], f"GAN stages {gan}")
    check([(int(h[0]), int(h[2])) for h in hpe] == [(2, n_aug), (2, 0)],
          f"HPE stages {hpe}")
    written = sorted(p.name for p in (Path(augmentation_dir_for(
        str(tree), "MM-Hand")) / "color").glob("*.png"))
    cfg = Config(model=ModelConfig(fine_size=FULL["size"]),
                 data=DataConfig(dataset="RHD", dataroot=str(tree),
                                 augmentation_ratio=0.5))
    ds = HPEMixDataset(cfg)
    marked = sorted(Path(p).name for p, m in
                    zip(ds.paths, ds.augmentation_map) if m)
    check(written == marked and len(written) == n_aug,
          f"{len(written)} fakes written, {len(marked)} marked")
    scores = re.findall(r"^(epe_mean|epe_median|auc): (\S+)$", out, re.M)
    check(len(scores) == 12 and all(math.isfinite(float(v))
                                    for _, v in scores),
          f"test_hpe scores {scores}")
    print(f"ratio driver (0.5, 1.0): 7 stages exited 0 in {seconds:.3f} s "
          f"(each stage its own process); GAN steps {gan}; HPE "
          f"steps, images/s and augmented reads {hpe}; {len(written)} fakes "
          f"in MM-Hand_{tree.name}/color, exactly the marked images; "
          f"test_hpe epe/auc {[float(v) for _, v in scores]}")



def preprocess_phase(tmp: Path) -> tuple[Path, Path, dict]:
    """Stage 1 from raw frames: an RHD-layout source (training and
    evaluation splits of 320x320 frames with two hands each) and an
    STB-layout source (B1 and B4, SK_color, BB_left and BB_right 640x480
    frames, labels/*.mat), cropped to 256 px by the port's CLIs.  Checks
    every crop's keypoints inside it and B4 under test/ only; returns the
    training and evaluation crop trees and the kernels' launches (none: host
    work)."""
    import numpy as np
    from PIL import Image

    from mmhand_torch.data.annotations import load_annotations
    from mmhand_torch.data.raw_sources import write_raw_rhd, write_raw_stb
    from mmhand_torch.scripts import create_rhd_db, create_stb_db

    size = FULL["size"]
    start = time.perf_counter()
    rhd = write_raw_rhd(tmp / "rhd_raw", PRE["rhd_frames"], SEED, "training")
    write_raw_rhd(tmp / "rhd_raw", PRE["rhd_eval_frames"], SEED + 1,
                  "evaluation")
    stb = write_raw_stb(tmp / "stb_raw", PRE["stb_frames"], SEED)
    print(f"raw sources: RHD {PRE['rhd_frames']} + {PRE['rhd_eval_frames']} "
          f"frames, STB 2 x 3 x {PRE['stb_frames']} frames, written in "
          f"{time.perf_counter() - start:.3f} s")
    train, test, stb_out = tmp / "img" / "train", tmp / "rhd_test", tmp / "stb"
    runs = [("create_rhd_db training", create_rhd_db.main,
             [rhd, str(train), str(size), "--split", "training"],
             PRE["rhd_frames"]),
            ("create_rhd_db evaluation", create_rhd_db.main,
             [rhd, str(test), str(size), "--split", "evaluation"],
             PRE["rhd_eval_frames"]),
            ("create_stb_db", create_stb_db.main, [stb, str(stb_out), str(size)],
             2 * 3 * PRE["stb_frames"])]
    total: dict[str, int] = {}
    for what, fn, argv, frames in runs:
        result, out, seconds, launches = _run_main(fn, argv)
        n = result if isinstance(result, int) else sum(result.values())
        check(n > 0 and not any(launches.values()),
              f"{what}: {n} crops, launches {launches}")
        print(f"{what}: {out}; {n} crops from {frames} frames in "
              f"{seconds:.3f} s, {n / seconds:.2f} crops/s (host clock)")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def inside(tree: Path, kinds) -> int:
        annos, count = load_annotations(str(tree)), 0
        for folder in kinds or annos:
            for name, anno in annos[folder].items():
                uv = np.asarray(anno["uv_coord"])
                check(uv.shape == (21, 2) and uv.min() >= 0
                      and uv.max() <= size, f"{tree}/{folder}/{name}: uv "
                      f"outside the crop")
                check((tree / folder / name).is_file(),
                      f"{tree}/{folder}/{name} not written")
                count += 1
        first = next(iter(annos[next(iter(kinds or annos))]))
        with Image.open(tree / next(iter(kinds or annos)) / first) as img:
            check(img.size == (size, size), f"{tree}: crop size {img.size}")
        return count

    for tree in (train, test):
        n = inside(tree, ("color", "depth", "mask"))
        check(n == 3 * len(load_annotations(str(tree))["color"]),
              f"{tree}: {n} crops")
    split = {s: list(load_annotations(str(stb_out / s))) for s in
             ("train", "test")}
    check(split == {"train": ["B1Counting"], "test": ["B4Counting"]},
          f"STB split {split}")
    for s in ("train", "test"):
        check(inside(stb_out / s, None) == 3 * PRE["stb_frames"],
              f"STB {s} crops")
    print("preprocessing: every crop's 21 keypoints lie inside its "
          f"{size} px frame; B4 only under test/")
    return train, test, total


def export_phase(tmp: Path, crops: Path) -> dict:
    """The baseline exports on the RHD training crops (pairs, keypoints,
    pix2pixhd with K3 in batches of 64) and the pose maps at 256 px, sigma
    6; one batch of labels held against the plain rasterizer run on the
    CPU, bit for bit.  Returns the kernels' launches in the pix2pixhd run."""
    import numpy as np
    import torch
    from PIL import Image

    from mmhand_torch.data.annotations import load_annotations
    from mmhand_torch.ops.jointsmap import (
        generate_jointsmap,
        generate_jointsmap_ref,
    )
    from mmhand_torch.scripts import export_baseline_formats, generate_pose_maps

    size, batch = FULL["size"], PRE["label_batch"]
    annos = load_annotations(str(crops))["color"]
    n = len(annos)
    for mode in ("pairs", "keypoints"):
        got, out, seconds, launches = _run_main(
            export_baseline_formats.main,
            [mode, str(crops), str(tmp / f"{mode}.csv")])
        check(got == n and not any(launches.values()),
              f"export {mode}: {got} rows, launches {launches}")
    labels_dir = tmp / "p2phd"
    got, out, seconds, p2p_launches = _run_main(
        export_baseline_formats.main,
        ["pix2pixhd", str(crops), str(labels_dir), "--size", str(size),
         "--device", "cuda", "--batch", str(batch)])
    check(got == n and p2p_launches == {
        "gaussian_heatmaps": 0, "bn_sums": 0, "bn_sums_backward": 0,
        "generate_jointsmap": -(-n // batch)},
        f"pix2pixhd: {got} labels, launches {p2p_launches}")
    print(f"export pix2pixhd: {n} labels and images in {seconds:.3f} s, "
          f"{n / seconds:.2f} images/s (PNG writes on the host), launches "
          f"{p2p_launches}")
    names = sorted(annos)[:batch]
    uv = torch.from_numpy(np.stack([np.asarray(annos[k]["uv_coord"], np.float32)
                                    for k in names]))
    z = torch.from_numpy(np.stack([np.asarray(annos[k]["depth"], np.float32)
                                   for k in names]))
    want = generate_jointsmap_ref(uv, z, size, size)
    card = generate_jointsmap(uv.cuda(), z.cuda(), size, size).cpu()
    written = np.stack([np.asarray(Image.open(labels_dir / "train_label"
                                              / f"color_{k}")) for k in names])
    check(torch.equal(card, want)
          and np.array_equal(written, want.numpy().astype(np.uint8)),
          "pix2pixhd labels differ from the plain rasterizer")
    print(f"pix2pixhd labels: a batch of {len(names)} equals the plain "
          f"rasterizer on the CPU bit for bit ({int((want > 0).sum())} bone "
          f"pixels)")

    got, out, seconds, launches = _run_main(
        generate_pose_maps.main,
        [str(tmp / "keypoints.csv"), str(tmp / "pose" / "trainP"), "--size",
         str(size), str(size), "--sigma", str(CSV_TRAIN["sigma"])])
    first = np.load(tmp / "pose" / "trainP" / "color" / f"{names[0]}.npy")
    check(got == n and first.shape == (size, size, 21)
          and 0.9 < float(first.max()) <= 1.0 and not any(launches.values()),
          f"pose maps: {got}, {first.shape}, max {first.max()}")
    print(f"generate_pose_maps: {n} maps of {first.nbytes} bytes in "
          f"{seconds:.3f} s, {n / seconds:.2f} maps/s (numpy on the host)")
    return p2p_launches


def csv_train_phase(tmp: Path) -> dict:
    """scripts.train --dataset MMHand on the CSV chain: the flagship
    Config() at batch 16, bf16, 6 steps over prerendered batches; losses and
    parameters finite, 101 K2 and K2b launches per step and no K1; one
    step by CUDA events and the host's read of one batch.  Returns the
    kernels' launches in the run."""
    import numpy as np
    import torch

    from mmhand_torch.data import build_dataset, make_prepare_batch
    from mmhand_torch.data.loader import PRERENDERED_KEYS
    from mmhand_torch.scripts import train as train_script
    from mmhand_torch.train.step import make_train_step

    steps, batch_size, size = CSV_TRAIN["steps"], CSV_TRAIN["batch"], FULL["size"]
    argv = ["--dataset", "MMHand", "--imageroot", str(tmp / "img"),
            "--poseroot", str(tmp / "pose"), "--pairLst",
            str(tmp / "pairs.csv"), "--use_flip", "--batchSize",
            str(batch_size), "--fineSize", str(size), "--max_steps",
            str(steps), "--print_freq", "1", "--checkpoints_dir",
            str(tmp / "csv_ckpt"), "--name", "csv_smoke", "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    result, out, seconds, launches = _run_main(train_script.main, argv)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(out)
    system = result.system
    cfg = system.config
    check(cfg.model.ngf == 64 and cfg.model.g_n_blocks == 9
          and cfg.precision.compute_dtype == "bfloat16"
          and cfg.data.dataset == "MMHand", "CSV train config")
    check(result.steps == steps, f"CSV train: {result.steps} steps")
    check(launches == {"gaussian_heatmaps": 0,
                       "bn_sums": BN_PER_STEP * steps,
                       "bn_sums_backward": BN_PER_STEP * steps,
                       "generate_jointsmap": 0},
          f"CSV train launches {launches}")
    lines = re.findall(r"\(epoch: \d+, iters: (\d+), time: [^)]*\) (.*)", out)
    check(len(lines) == steps, f"{len(lines)} CSV loss lines")
    for it, rest in lines:
        values = dict(re.findall(r"(\w+): (\S+)", rest))
        check(len(values) == 6 and all(math.isfinite(float(v))
                                       for v in values.values()),
              f"CSV step {it} losses {values}")
    check(nets_finite(system), "CSV train: a parameter is not finite")

    # the host's read of one prerendered batch (PIL decode of 64 PNGs, 32
    # pose maps from .npy), host clock; the copy to the card and one step
    dataset = build_dataset(cfg)
    start = time.perf_counter()
    items = [dataset[i] for i in range(batch_size)]
    raw = {k: np.stack([it[k] for it in items]) for k in PRERENDERED_KEYS}
    read_ms = (time.perf_counter() - start) * 1e3
    npy = raw["P1"].nbytes + raw["P2"].nbytes
    prepare = make_prepare_batch(cfg.data.sigma, "cuda")
    batch = prepare(raw)
    step = make_train_step(system)
    lr = cfg.optim.lr
    copy_ms = cuda_ms(lambda: prepare(raw), iters=5, warmup=1)
    step_ms = cuda_ms(lambda: step(batch, lr), iters=5, warmup=1)
    rate = result.images_per_sec
    check(rate is not None and rate > 0, "CSV train printed no steady rate")
    print(f"CSV train: {steps} steps at batch {batch_size} in {seconds:.3f} s "
          f"(build, cuDNN warm-up and the latest save included), {rate} "
          f"images/s in the loop after the first step; one step "
          f"{step_ms:.3f} ms (CUDA events, median of 5), "
          f"{batch_size / step_ms * 1e3:.2f} images/s; peak device memory "
          f"{peak_gib:.2f} GiB; launches {launches}")
    print(f"CSV host work per step: batch read {read_ms:.3f} ms (host clock; "
          f"{npy} bytes of .npy pose maps, {sum(a.nbytes for a in raw.values())}"
          f" bytes of float32 arrays in all); copy to the card {copy_ms:.3f} "
          f"ms (CUDA events)")
    return launches


def patn2_phase(test_crops: Path) -> dict:
    """bench_baselines --arch patn2 at full width (ngf 64, 9 blocks, 256 px,
    eval batch 8) over the RHD evaluation crops: finite scores under random
    weights, K1 twice per batch (P1, P2) and no other kernel; K1 held
    against its plain version on the first batch's keypoints.  Returns the
    kernels' launches in the run."""
    import warnings

    import numpy as np
    import torch

    from mmhand_torch.config import Config, DataConfig, ModelConfig
    from mmhand_torch.data import HostLoader, build_dataset, make_prepare_batch
    from mmhand_torch.data.annotations import load_annotations
    from mmhand_torch.scripts import bench_baselines

    size, batch = FULL["size"], PATN2["batch"]
    n = len(load_annotations(str(test_crops))["color"])
    argv = ["--arch", "patn2", "--dataset", "RHD", "--dataroot",
            str(test_crops), "--fineSize", str(size), "--eval_batch",
            str(batch), "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    scores, out, seconds, launches = _run_main(bench_baselines.main, argv)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(out.splitlines()[-1])
    _check_scores("bench_baselines patn2", scores, n)
    batches = -(-n // batch)
    check(launches == {"gaussian_heatmaps": 2 * batches, "bn_sums": 0,
                       "bn_sums_backward": 0, "generate_jointsmap": 0},
          f"PATN2 launches {launches}")

    cfg = Config(model=ModelConfig(fine_size=size),
                 data=DataConfig(dataset="RHD", dataroot=str(test_crops)),
                 is_train=False)
    raw = next(HostLoader(build_dataset(cfg), batch, shuffle=False,
                          num_threads=1).epoch(0))
    for key in ("src_uv", "tgt_uv"):
        uv = torch.from_numpy(raw[key]).cuda()
        err, exempt, skipped = check_heatmaps(uv, size, size, cfg.data.sigma,
                                              f"PATN2 {key}")
    prepared = make_prepare_batch(cfg.data.sigma, "cuda")(
        {k: v for k, v in raw.items() if not k.endswith("paths")})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = bench_baselines.build_baseline(cfg, "patn2", "cuda")
    g_in = (prepared["H1"], torch.cat([prepared["P1"], prepared["P2"]], -1))
    with torch.inference_mode():
        g_ms = cuda_ms(lambda: net(g_in), iters=5)
    print(f"bench_baselines patn2: {n} images at batch {batch} in "
          f"{seconds:.3f} s (FID's 2048-d sqrtm on the host included), "
          f"{scores['images_per_sec_steady']} images/s after the first "
          f"batch, PATN2 G {g_ms:.3f} ms per batch of {batch} (CUDA events), "
          f"peak device memory {peak_gib:.2f} GiB, launches {launches}; K1 "
          f"on the batch's keypoints within {err} of its plain version")
    return launches


def pose_resnet_phase() -> dict:
    """PoseResNet-50 at batch 32 and 256 px in bf16: an eval forward, one
    train-mode forward and backward counting K2/K2b at its 56 BatchNorms;
    K2 over those 56 inputs against torch.batch_norm_stats, and K2 and K2b
    on each of them against their plain versions; the same
    weights in float32 (TF32 off) at batch 2 held against the plain
    version on the CPU: output, running statistics and every gradient.
    Returns the kernels' launches in the train-mode pass."""
    import copy

    import torch

    from mmhand_torch.models.check_nets import (
        make_test_pose_resnet,
        pose_resnet_f64,
    )
    from mmhand_torch.models.layers import BatchNorm2d
    from mmhand_torch.ops.bn_stats import bn_sums, bn_sums_ref

    size, batch, sites = FULL["size"], POSE["batch"], POSE["bn_sites"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = make_test_pose_resnet(POSE["size"], torch.bfloat16, SEED).to(
        device="cuda", memory_format=torch.channels_last)
    x = torch.rand(batch, size, size, 3, generator=gen, device="cuda") * 2 - 1
    w = torch.randn(batch, size // 4, size // 4, 21, generator=gen,
                    device="cuda")
    net.eval()
    with torch.inference_mode():
        out = net(x)
        eval_ms = cuda_ms(lambda: net(x), iters=5)
    check(out.shape == (batch, size // 4, size // 4, 21)
          and bool(torch.isfinite(out).all()), "PoseResNet eval output")

    def train_pass():
        net.zero_grad(set_to_none=True)
        (net(x) * w).sum().backward()

    net.train()
    counted = kernel_counters()
    for f in counted.values():
        f.launches = 0
    train_pass()
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counted.items()}
    check(launches == {"gaussian_heatmaps": 0, "bn_sums": sites,
                       "bn_sums_backward": sites, "generate_jointsmap": 0},
          f"PoseResNet train launches {launches}")
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in net.parameters()), "PoseResNet gradients")
    train_ms = cuda_ms(train_pass, iters=5, warmup=1)

    inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[0].detach()))
        for m in net.modules() if isinstance(m, BatchNorm2d)]
    with torch.no_grad():
        net(x)
    for h in hooks:
        h.remove()
    check(len(inputs) == sites, f"{len(inputs)} BatchNorm inputs")
    k2_ms = cuda_ms(lambda: [bn_sums(t) for t in inputs], iters=5)
    lib_ms = cuda_ms(lambda: [torch.batch_norm_stats(t, 1e-5) for t in inputs],
                     iters=5)
    plain_ms = cuda_ms(lambda: [bn_sums_ref(t) for t in inputs], iters=5)
    k2_device = kernel_device_ms(lambda: [bn_sums(t) for t in inputs],
                                 K2_KERNELS, calls=5)
    lib_device = kernel_device_ms(
        lambda: [torch.batch_norm_stats(t, 1e-5) for t in inputs],
        ("batch_norm",), calls=5)
    k2_bound = sum(bound(t.numel() * t.element_size() + 2 * t.shape[1] * 4,
                         3 * t.numel())[0] for t in inputs)
    gb = sum(t.numel() * t.element_size() for t in inputs) / 1e9
    report, _ = profile_step(train_pass, "PoseResNet-50 train pass",
                             {"K2": K2_KERNELS, "K2b": K2B_KERNELS})
    print(report)
    print(f"PoseResNet-50 at batch {batch}, {size} px, bf16: eval forward "
          f"{eval_ms:.3f} ms, train-mode forward and backward {train_ms:.3f} "
          f"ms (CUDA events, median of 5); launches {launches}")
    print(f"PoseResNet-50 BatchNorm moments over its {sites} train-mode "
          f"inputs ({gb:.3f} GB, bf16): K2 {k2_ms:.4f} ms by CUDA events "
          f"({k2_device:.4f} ms of device time), torch.batch_norm_stats "
          f"{lib_ms:.4f} ms ({lib_device:.4f} ms), plain {plain_ms:.4f} ms, "
          f"bound {k2_bound:.4f} ms")
    print(hold_bn_inputs(f"PoseResNet-50 at batch {batch}", inputs))
    del inputs, net

    # the same weights in float32 at batch 2: card (K2, K2b) against the
    # plain version on the CPU; the gradients also against float64
    cpu = make_test_pose_resnet(POSE["size"], None, SEED).train()
    card = copy.deepcopy(cpu).to(device="cuda", memory_format=torch.channels_last)
    f64 = copy.deepcopy(cpu).double()
    xs, ws = x[:POSE["cpu_batch"]].float().cpu(), w[:POSE["cpu_batch"]].cpu()
    with tf32_off():
        got = card(xs.cuda())
        (got * ws.cuda()).sum().backward()
    want = cpu(xs)
    (want * ws).sum().backward()
    (pose_resnet_f64(f64, xs.double()) * ws.double()).sum().backward()
    got, want = got.detach(), want.detach()
    out_err = float((got.cpu() - want).abs().max())
    check(out_err <= 1e-4 + 1e-4 * float(want.abs().max()),
          f"PoseResNet card output differs from the CPU by {out_err}")
    stats_err = 0.0
    a = card.state_dict()
    for k, v in cpu.state_dict().items():
        if "running" in k:
            e = float((a[k].cpu() - v).abs().max())
            check(e <= 1e-5 + 1e-4 * float(v.abs().max()),
                  f"PoseResNet {k} differs by {e}")
            stats_err = max(stats_err, e)
    # each gradient's error against float64, as a share of its norm: the
    # card's f32 within 4x the CPU's f32.  At batch 2 the f32 gradients of
    # this random net lie up to ~15% from float64 in layer4 on the CPU
    # alone (torch's own f32 BatchNorm too): rounding amplified through
    # 50 train-mode BatchNorms, the same on either side
    worst = (0.0, 0.0)
    for (k, p), q, r in zip(cpu.named_parameters(), card.parameters(),
                            f64.parameters()):
        scale = float(r.grad.norm())
        e_cpu = float((p.grad.double() - r.grad).norm()) / scale
        e_card = float((q.grad.cpu().double() - r.grad).norm()) / scale
        check(e_card <= 4 * e_cpu + 1e-6,
              f"PoseResNet grad {k}: card {e_card:.3e}, CPU {e_cpu:.3e} "
              f"from float64")
        worst = max(worst, (e_card, e_cpu))
    print(f"PoseResNet-50 train pass at batch {POSE['cpu_batch']}, f32, TF32 "
          f"off, card against the CPU: output within {out_err:.3e}, running "
          f"statistics within {stats_err:.3e}; gradients against float64: "
          f"the card's at most {worst[0]:.3e} of a tensor's norm, the CPU's "
          f"{worst[1]:.3e} there")
    return launches


def zoo_nets_phase() -> dict:
    """NLayerDiscriminator, PixelDiscriminator and PATN2Stream at full
    width: eval forwards against the CPU at 64 px in float32 (TF32 off);
    train-mode forwards and backwards at batch 8, 256 px, bf16, counting
    K2/K2b, and K2 and K2b on each of their BatchNorm inputs against their
    plain versions.  Then every init type on the flagship generator, each conv
    weight's std against its formula and the orthogonal ones
    semi-orthogonal.  Returns the kernels' launches in the train passes."""
    import copy

    import numpy as np
    import torch

    from mmhand_torch.models.baselines import (
        NLayerDiscriminator,
        PATN2Stream,
        PixelDiscriminator,
    )
    from mmhand_torch.models.generator import Generator
    from mmhand_torch.models.layers import (
        INIT_TYPES,
        BatchNorm2d,
        init_weights,
        weight_fans,
    )

    size = FULL["size"]
    rng = np.random.RandomState(SEED)
    # each net and its train-mode BatchNorms
    nets = {"NLayerDiscriminator": (NLayerDiscriminator, 3),
            "PixelDiscriminator": (PixelDiscriminator, 1),
            "PATN2Stream": (PATN2Stream, 35)}
    total = {k: 0 for k in kernel_counters()}
    for name, (cls, bns) in nets.items():
        gen = torch.Generator().manual_seed(SEED)
        cpu = init_weights(cls(compute_dtype=None), "normal", gen).eval()
        with torch.no_grad():
            for m in cpu.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0, 0.05, generator=gen)
                    m.running_var.uniform_(0.1, 1.0, generator=gen)

        def inputs(batch, px, device):
            x = torch.from_numpy(rng.uniform(-1, 1, (batch, px, px, 3)).astype(
                np.float32)).to(device)
            if cls is not PATN2Stream:
                return x
            p = torch.from_numpy(rng.uniform(0, 1, (batch, px, px, 42)).astype(
                np.float32)).to(device)
            return (x, p)

        card = copy.deepcopy(cpu).to(device="cuda",
                                     memory_format=torch.channels_last)
        small = inputs(2, 64, "cpu")
        with torch.no_grad(), tf32_off():
            want = cpu(small)
            got = card(tuple(t.cuda() for t in small)
                       if isinstance(small, tuple) else small.cuda())
        err = float((got.cpu() - want).abs().max())
        check(err <= 1e-4 + 1e-4 * float(want.abs().max()),
              f"{name}: card differs from the CPU by {err}")
        card.compute_dtype = torch.bfloat16
        card.train()
        big = inputs(8, size, "cuda")
        bn_inputs = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: bn_inputs.append(args[0].detach()))
            for m in card.modules() if isinstance(m, BatchNorm2d)]
        counted = kernel_counters()
        for f in counted.values():
            f.launches = 0
        out = card(big)
        out.float().square().mean().backward()
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counted.items()}
        for h in hooks:
            h.remove()
        check(bool(torch.isfinite(out).all())
              and launches["bn_sums"] == launches["bn_sums_backward"] == bns
              and len(bn_inputs) == bns,
              f"{name}: train pass, launches {launches}, "
              f"{len(bn_inputs)} BatchNorm inputs")
        print(f"{name}: eval at 64 px within {err:.3e} of the CPU (f32); "
              f"train-mode pass at batch 8, {size} px, bf16: output "
              f"{tuple(out.shape)}, launches {launches}")
        print(hold_bn_inputs(f"{name} at batch 8, {size} px", bn_inputs))
        for k, v in launches.items():
            total[k] += v
        del card, out, bn_inputs

    for init_type in INIT_TYPES:
        g = init_weights(Generator(compute_dtype=None), init_type,
                         torch.Generator().manual_seed(SEED)).requires_grad_(False)
        worst, checked = 0.0, 0
        for m in g.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                check(not m.bias.any() and abs(float(m.weight.mean()) - 1)
                      < 0.05, f"{init_type}: norm parameters")
            if not isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                continue
            fan_in, fan_out, cout = weight_fans(m)
            w = m.weight.detach()
            if init_type == "orthogonal":
                rows = (w.transpose(0, 1) if isinstance(
                    m, torch.nn.ConvTranspose2d) else w).reshape(cout, -1)
                gram = rows @ rows.T if rows.shape[0] <= rows.shape[1] \
                    else rows.T @ rows
                dev = float((gram - torch.eye(len(gram))).abs().max())
                check(dev < 1e-4, f"orthogonal: {dev} off semi-orthogonal")
            else:
                std = {"normal": 0.02,
                       "xavier": 0.02 * (2.0 / (fan_in + fan_out)) ** 0.5,
                       "kaiming": (2.0 / fan_in) ** 0.5}[init_type]
                dev = abs(float(w.std()) / std - 1)
                check(dev < 6.0 / (2.0 * w.numel()) ** 0.5,
                      f"{init_type}: std {float(w.std())} against {std}")
            worst, checked = max(worst, dev), checked + 1
        print(f"init {init_type} on the flagship G: {checked} conv weights, "
              f"worst {'|W W^T - I|' if init_type == 'orthogonal' else 'relative std error'} "
              f"{worst:.3e}")
    return total


def main() -> int:
    if not (ROOT / "mmhand_torch" / "__init__.py").exists():
        print("chip_smoke: mmhand_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    workers = {"--dp-worker": dp_worker, "--gloo-worker": gloo_worker}
    if len(sys.argv) == 3 and sys.argv[1] in workers:
        workers[sys.argv[1]](sys.argv[2])
        return 0
    from mmhand_torch.ops import _build

    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"card: {card}")

    fresh = not _build.library_path().exists()
    start = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - start:.3f} s "
          f"({'compiled with nvcc' if fresh else 'already built'})")

    k1 = kernel_phase()
    k2, k2b = bn_kernel_phase()
    k3 = jointsmap_kernel_phase()
    small_reference_phase()
    small_train_phase()
    small_eval_phase()
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        gen_k1 = slice_phase(tmp)
        check(gen_k1 > 0, "K1 was not launched on the generation path")
        paths["generation"] = {"gaussian_heatmaps": gen_k1}
        paths["train"], step_ms = train_slice_phase(tmp)
        paths["fp16 train"] = fp16_train_phase(tmp)
        paths["resume"] = resume_phase(tmp)
        paths["NCCL world 1"] = nccl_phase(tmp, step_ms)
        paths["gloo 2 ranks (rank 0)"] = gloo_phase(tmp)
        paths["evaluation"] = eval_slice_phase(tmp)
        paths["HPE train"], tree = hpe_train_phase(tmp)
        paths["HPE test"] = hpe_test_phase(tmp, tree)
        ratio_driver_phase(tmp, tree)
        crops, test_crops, paths["preprocessing"] = preprocess_phase(tmp)
        paths["pix2pixhd export"] = export_phase(tmp, crops)
        paths["CSV train"] = csv_train_phase(tmp)
        paths["PATN2 scoring"] = patn2_phase(test_crops)
        paths["PoseResNet-50 train"] = pose_resnet_phase()
        paths["zoo nets train"] = zoo_nets_phase()
    # K1 runs on every path that renders heatmaps, K2 and K2b on the train
    # paths, K3 on the baselines' evaluation path and the pix2pixhd export
    for rec, name in ((k1, "gaussian_heatmaps"), (k2, "bn_sums"),
                      (k2b, "bn_sums_backward"), (k3, "generate_jointsmap")):
        rec["launches"] = sum(p.get(name, 0) for p in paths.values())
        check(rec["launches"] > 0, f"{name} was launched on no path")
    check(all(paths[p]["bn_sums"] > 0 and paths[p]["bn_sums_backward"] > 0
              for p in paths if p not in ("generation", "evaluation",
                                          "HPE train", "HPE test",
                                          "preprocessing", "pix2pixhd export",
                                          "PATN2 scoring")),
          "K2 or K2b was not launched on a train path")
    print("launches by path: " + "; ".join(
        f"{p} {dict((k, v) for k, v in l.items() if v)}"
        for p, l in paths.items()))

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "device_ms", "skipped_share"]
    print(json.dumps({"kernels": [{k: rec[k] for k in order}
                                  for rec in (k1, k2, k2b, k3)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
