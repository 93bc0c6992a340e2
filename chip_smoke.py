#!/usr/bin/env python3
"""The PyTorch port (mmhand_torch) on one NVIDIA GPU: its kernel table and
a full-width drive of every user path.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from mmhand_torch/csrc/ with nvcc.
2. The kernel table (PERF.md section 6): each kernel's time by CUDA
   events, its device time by the profiler, its plain version's time, the
   one PyTorch call that computes the same function where there is one, and
   its bound (``benchmark.roofline``): K1 (heatmaps), K2 (BatchNorm sums),
   K2b (their backward), the train-mode normalize (``bn_apply``), the
   reflect pad (``reflect_pad``) and K3 (the jointsmap rasterizer).  Each
   is held against its plain version at the shape it is timed at: K1
   within 1e-6 off the clip boundary and 0 where it skips, K2 within 1e-5
   of sum |x| and sum x^2, K2b bit for bit, K3 bit for bit against the
   CPU, the normalize within a few roundings, the pad and its backward
   bit for bit.  K2, the normalize and the pad are also timed at the main
   paths' sites by CUDA graphs, beside the torch kernels they replace.
3. Drives every user path at full width through its script's ``main()``
   (or the library call a path has no script for), with the checks along
   it (losses, scores and parameters finite, nets moved, files written)
   and the launches of each kernel: generation (``aug``); training
   (``train`` in bf16, fp16 with loss scaling, resumed, NCCL at world 1,
   two gloo ranks on the card, the kill-and-resume demo); evaluation
   (``evaluate_gan``, ``bench_baselines``); HPE (``train_hpe``,
   ``test_hpe``, the ratio driver ``mm_train_ratio --with_hand3d``);
   stages 1-2 from raw frames (``create_rhd_db``, ``create_stb_db``,
   ``export_baseline_formats``, ``generate_pose_maps``, ``train --dataset
   MMHand``, ``bench_baselines --arch patn2``); the library nets
   (PoseResNet-50, the PatchGANs, PATN2, every init_type); hand3d
   (``train_hand3d``, ``create_hand3d_db``, ``eval_hand3d``,
   ``run_hand3d``, ``handpose_judge``); the MSRA/V2V group.  Each path's
   launches of the normalize's two kernels must equal K2's and K2b's; each
   path that runs a net with reflect padding (the GAN's train, resume,
   fp16, NCCL, generation, evaluation and kill-and-resume paths, the
   ResNet and PATN2 baselines) launches the pad once per site, and the
   HPE, preprocessing, export, PoseResNet, hand3d and MSRA/V2V paths not
   at all.

Every other check has its own home: each kernel's sweep over shapes,
types and edge cases, and the card against the CPU, in
tests/test_torch_cuda.py (``python -m
pytest --noconftest -m cuda tests/test_torch_cuda.py``), the cells' rates
and per-layer times in the benchmark (``python3 -m benchmark.run``).

It prints ``launches by path``, ``phase seconds``, the kernels' JSON line,
the card's name and power limit, then ``{"ok": true, "device": {...}}`` as
the last line.  Any failed check raises and the exit code is not 0;
without a CUDA device, or without the package beside this file, it stops
before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
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
PAD_SOURCE = "mmhand_torch/csrc/reflect_pad.cu"
# each kernel's CUDA kernels, by the names the profiler shows
K1_KERNELS = ("gaussian_heatmaps_kernel",)
K2_KERNELS = ("bn_sums_kernel",)
K2B_KERNELS = ("bn_sums_backward_kernel",)
K3_KERNELS = ("jointsmap_kernel",)
BN_APPLY_KERNELS = ("bn_apply_kernel",)
BN_APPLY_BWD_KERNELS = ("bn_apply_backward_kernel",)
PAD_KERNELS = ("reflect_pad_kernel",)
PAD_BWD_KERNELS = ("reflect_pad_backward_kernel",)
# the train slice: the JAX Config() flagship (ngf 64, 9 PATBlocks, 256 px),
# batch 16, a few steps; its BatchNorms: 47 in G, 9 in each D, run once in
# G, twice in the G loss's D forwards and twice in each D phase
TRAIN = dict(steps=6, batch=16)
# the resume and NCCL slices: 3 flagship steps each (3 + 3 for resume)
RESUME_STEPS = 3
BN_PER_STEP = 47 + 2 * 9 + 2 * 9 + 2 * 9
# the kill-and-resume demo at the flagship's width (batch 16, 256 px, bf16,
# the 64-item block tree): leg 1 saves at step 950 and is killed at its
# 96th print of 10 (step 960); leg 2 resumes at step 950 and runs 50 more.
# On this tree the pair_L1loss holds near 8 until the generator starts to
# tell the targets apart, at a step that varies from run to run (it first
# fell below 0.7 of the first tenth's mean at steps 450 to 780 in the runs
# PERF.md lists), so the kill comes late: continuity is then read where a
# generator that restarted from scratch (near 8) would fail it
LONGRUN = dict(items=64, save_every=950, print_freq=10, kill_after_prints=96,
               steps2=50)
# the evaluation slice: 64 pairs at 256 px; evaluate_gan at batch 16, the
# baselines at batch 8 (the JAX scripts' defaults)
EVAL = dict(n_items=64, gan_batch=16, baseline_batch=8)
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
# PoseResNet-50 (SimpleBaselines) with its 56 BatchNorms: batch 32 at 256 px
POSE = dict(size=50, batch=32, bn_sites=56)
# the hand3d stack: the scripts' 256 px, crop 256 and batch 8, float32
# (mmhand_tpu's dtype), 6 train steps per subnet
HAND3D = dict(size=256, crop=256, batch=8, steps=6)
# the MSRA/V2V group: 16 MSRA-layout frames, 8 of them voxelized at 64^3
# (cube 200 mm) with augmentation; the nets at their fixed widths,
# VoxelGenerator and VoxelDiscriminator at batch 8 on 64^3, DepthGenerator
# at batch 32, DepthDiscriminator at batch 8 on 256x256; the pose search
# over MSRA15's 76,375 frames, k 25
MSRA = dict(frames=16, samples=8, cubic=200.0, depth_g_batch=32,
            depth_d_batch=8, poses=76375, k=25)
# the four nets' train-mode BatchNorms: 31 + 4 + 5 + 3
MSRA_BN_SITES = {"VoxelGenerator": 31, "VoxelDiscriminator": 4,
                 "DepthGenerator": 5, "DepthDiscriminator": 3}
# K2's per-site table (bn_site_phase): the GAN train step's four
# train-mode BatchNorm input shapes at batch 16 in bf16, with their calls
# per step (10 + 10 + 16 + 65 = BN_PER_STEP), and the MSRA/V2V group's
# C=1 and C=21 sites and its largest 5-D one, f32 (msra_v2v_phase's nets)
GAN_BN_SITES = [((16, 64, 256, 256), 10), ((16, 128, 128, 128), 10),
                ((16, 512, 64, 64), 16), ((16, 256, 64, 64), 65)]
MSRA_BN_TIMED = [(8, 1, 64, 64, 64), (32, 1, 128, 128), (8, 1, 256, 256),
                 (8, 21, 256, 256), (8, 16, 64, 64, 64)]
# the flagship GAN step's reflect-pad sites at batch 16: (input shape,
# type, pad, forward calls, backward calls) a step.  G pads 58 times: its
# three f32 stems (3, 42, 6 channels, pad 3), 54 times in its PATBlocks
# (pad 1 at 64 px: 22 on 256 channels, and 32 on the attention streams'
# 512 from the second block on), once on the way up (64 channels, pad 3).
# D_PB and D_PP pad 7 times each (the f32 stem on 6 or 24 channels, 6 in
# their ResnetBlocks) in each of their three forwards a step (the G loss,
# real, fake).  Backward: G's stems and the D phases' stems take inputs
# that need no gradient
GAN_PAD_SITES = [((16, 3, 256, 256), "float32", 3, 1, 0),
                 ((16, 42, 256, 256), "float32", 3, 1, 0),
                 ((16, 6, 256, 256), "float32", 3, 1 + 3, 1),
                 ((16, 24, 256, 256), "float32", 3, 3, 1),
                 ((16, 256, 64, 64), "bfloat16", 1, 22 + 36, 22 + 12 + 24),
                 ((16, 512, 64, 64), "bfloat16", 1, 32, 32),
                 ((16, 64, 256, 256), "bfloat16", 3, 1, 1)]
PAD_PER_STEP = tuple(sum(site[i] for site in GAN_PAD_SITES) for i in (3, 4))
G_PAD_SITES = 58
# PATN2's generator: two stems, 9 PATBlocks of two streams, the up path
PATN2_PAD_SITES = 2 + 9 * 2 * 2 + 1
# the CycleGAN ResnetGenerator of bench_baselines: the stem, 9 ResnetBlocks
# of two, the last conv
RESNET_PAD_SITES = 1 + 9 * 2 + 1
# calls per CUDA graph in graph_ms, and the L2 cache the inputs must
# outgrow so that every call reads its input from HBM, as the bound counts
GRAPH_CALLS = 50
L2_BYTES = 50e6


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


def graph_ms(fns, replays: int = 5) -> float:
    """Device milliseconds of one call: the calls ``fns`` (each a function
    of no argument) captured in one CUDA graph, replayed ``replays`` times
    between CUDA events; the median replay over ``len(fns)``.  The graph
    takes the wrapper's host work out, so this is the device's time from
    one call's start to the next one's; it fails unless finite."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(fns))
    del graph
    ms = statistics.median(times)
    check(math.isfinite(ms) and ms > 0, f"graph time {ms}")
    return ms


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


def kernel_phase():
    """K1's row of the kernel table at the main paths' shape, sigma 6, on
    keypoints uniform over the frame +-10%; the share of elements its
    early-out skips on the main paths' target keypoints."""
    import torch

    from benchmark import roofline
    from mmhand_torch.config import Config, DataConfig, ModelConfig
    from mmhand_torch.ops.heatmap import (
        CLIP_LO,
        gaussian_heatmaps,
        gaussian_heatmaps_ref,
        skipped_elements,
    )

    rng = torch.Generator().manual_seed(SEED)
    batch, size, sigma = FULL["gen_batch"], FULL["size"], 6.0
    uv = ((torch.rand(batch, 21, 2, generator=rng) * 1.2 - 0.1) * size).cuda()
    skipped = float(skipped_elements(uv, size, size, sigma).float().mean())
    got = gaussian_heatmaps(uv, size, size, sigma)
    want = gaussian_heatmaps_ref(uv, size, size, sigma)
    # where exp's last bit flips the clip, one side is 0, the other ~CLIP_LO
    flip = (torch.minimum(got, want).eq(0)
            & (torch.maximum(got, want) - CLIP_LO).abs().le(2e-6))
    err = float(((got - want).abs() * ~flip).max())
    flips = int(flip.sum())
    check(err <= 1e-6 and flips <= 1e-3 * got.numel()
          and not bool(got[skipped_elements(uv, size, size, sigma)].any()),
          f"K1: {err} from the plain version off the clip boundary, "
          f"{flips} pixels on it, or a skipped element not 0")
    ms = cuda_ms(lambda: gaussian_heatmaps(uv, size, size, sigma))
    device_ms = kernel_device_ms(
        lambda: gaussian_heatmaps(uv, size, size, sigma), K1_KERNELS)
    plain_ms = cuda_ms(lambda: gaussian_heatmaps_ref(uv, size, size, sigma))
    # bytes set the bound: at most 9 operations an f32 element written,
    # under the H100's 20 a byte (K2, K2b: 1.5 and 0.5 a bf16 byte)
    k1_bound = roofline.k1_bound_s(uv, size, size, sigma) * 1e3
    tiny = uv[:1] * (8.0 / size)
    wrapper_us = host_us(lambda: gaussian_heatmaps(tiny, 8, 8, sigma))
    # the keypoints the main paths render: the synthetic set's first batch
    cfg = Config(model=ModelConfig(fine_size=size),
                 data=DataConfig(dataset="synthetic"), is_train=False)
    tgt = torch.from_numpy(raw_batch(cfg, batch)["tgt_uv"])
    main_skipped = float(skipped_elements(tgt, size, size, sigma).float()
                         .mean())
    print(f"K1 gaussian_heatmaps ({batch}, {size}, {size}, 21), keypoints "
          f"uniform over the frame +-10%: early-out skips {skipped:.4f} of "
          f"the elements ({main_skipped:.4f} on the main paths' tgt_uv); "
          f"kernel {ms:.4f} ms per call ({device_ms:.4f} ms of device time, "
          f"profiler; the wrapper's host work {wrapper_us:.1f} us per call "
          f"at (1, 8, 8)), plain {plain_ms:.4f} ms ({err:.3g} apart off the "
          f"clip boundary, {flips} pixels on it), bound {k1_bound:.4f} ms "
          f"(bytes); no single PyTorch call computes the same function")
    return {"name": "gaussian_heatmaps", "route": "cuda",
            "source": "mmhand_torch/csrc/heatmap.cu", "replaces": K1_REPLACES,
            "max_abs_err": err, "max_rel_err": None,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": k1_bound,
            "bound_by": "bytes", "library_ms": None, "device_ms": device_ms,
            "skipped_share": main_skipped}


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least milliseconds for the work on an H100 SXM at 700 W
    (``benchmark.roofline.bound_s``), and which of bytes and f32
    operations sets it."""
    from benchmark import roofline

    by_bytes = (nbytes / roofline.HBM_BYTES_PER_S
                >= flops / roofline.F32_FLOPS)
    return (roofline.bound_s(nbytes, flops) * 1e3,
            "bytes" if by_bytes else "operations")


def bn_kernel_phase():
    """K2's and K2b's rows of the kernel table at the train step's largest
    BatchNorm input, (16, 64, 256, 256) bf16, beside the plain versions,
    ``torch.batch_norm_stats`` and ``torch.addcmul`` (K2b's function as one
    call, g1 and g2 cast to bf16)."""
    import torch

    from benchmark import roofline
    from mmhand_torch.ops.bn_stats import (
        bn_sums,
        bn_sums_backward,
        bn_sums_backward_ref,
        bn_sums_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shape, c = GAN_BN_SITES[0][0], GAN_BN_SITES[0][0][1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 1.5 + 0.3
         ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    g1 = torch.randn(c, generator=gen, device="cuda")
    g2 = torch.randn(c, generator=gen, device="cuda")
    g1x = g1.to(x.dtype).view(1, c, 1, 1)
    g2x = g2.to(x.dtype).view(1, c, 1, 1)
    ms = cuda_ms(lambda: bn_sums(x))
    plain_ms = cuda_ms(lambda: bn_sums_ref(x))
    library_ms = cuda_ms(lambda: torch.batch_norm_stats(x, 1e-5))
    device_ms = kernel_device_ms(lambda: bn_sums(x), K2_KERNELS)
    bwd_ms = cuda_ms(lambda: bn_sums_backward(x, g1, g2))
    bwd_plain_ms = cuda_ms(lambda: bn_sums_backward_ref(x, g1, g2))
    bwd_library_ms = cuda_ms(lambda: torch.addcmul(g1x, g2x, x, value=2))
    bwd_device_ms = kernel_device_ms(lambda: bn_sums_backward(x, g1, g2),
                                     K2B_KERNELS)
    addcmul_device_ms = kernel_device_ms(
        lambda: torch.addcmul(g1x, g2x, x, value=2),
        ("addcmul", "elementwise"))
    # K2 sums in f32 in another order than the plain version: held at 1e-5
    # of sum |x| and sum x^2, which bound any order's rounding; K2b is the
    # plain formula in the same order, so bit for bit
    (s1, s2), (r1, r2) = bn_sums(x), bn_sums_ref(x)
    rel = max(float(((s1 - r1).abs() / x.float().abs().sum((0, 2, 3))).max()),
              float(((s2 - r2).abs() / r2).max()))
    err = max(float((s1 - r1).abs().max()), float((s2 - r2).abs().max()))
    check(rel <= 1e-5, f"K2 {shape}: relative error {rel}")
    check(torch.equal(bn_sums_backward(x, g1, g2),
                      bn_sums_backward_ref(x, g1, g2)),
          f"K2b {shape}: differs from the plain version")
    k2_bound = roofline.k2_bound_s(x.numel(), x.element_size(), c) * 1e3
    k2b_bound = roofline.k2b_bound_s(x.numel(), x.element_size(), c) * 1e3
    print(f"K2 bn_sums {shape} bf16: kernel {ms:.4f} ms ({device_ms:.4f} ms "
          f"of device time), plain {plain_ms:.4f} ms (relative error "
          f"{rel:.3g}), torch.batch_norm_stats {library_ms:.4f} ms, bound "
          f"{k2_bound:.4f} ms (bytes)")
    print(f"K2b bn_sums_backward {shape} bf16: kernel {bwd_ms:.4f} ms "
          f"({bwd_device_ms:.4f} ms of device time), plain {bwd_plain_ms:.4f} "
          f"ms (bit for bit), torch.addcmul {bwd_library_ms:.4f} ms "
          f"({addcmul_device_ms:.4f} ms of device time), bound "
          f"{k2b_bound:.4f} ms (bytes)")
    return [{"name": "bn_sums", "route": "cuda", "source": BN_SOURCE,
             "replaces": K2_REPLACES, "max_abs_err": err, "max_rel_err": rel,
             "ms": ms, "plain_ms": plain_ms,
             "bound_ms": k2_bound, "bound_by": "bytes",
             "library_ms": library_ms, "device_ms": device_ms,
             "skipped_share": None},
            {"name": "bn_sums_backward", "route": "cuda", "source": BN_SOURCE,
             "replaces": K2B_REPLACES, "max_abs_err": 0.0,
             "max_rel_err": None, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
             "bound_ms": k2b_bound, "bound_by": "bytes",
             "library_ms": bwd_library_ms, "device_ms": bwd_device_ms,
             "skipped_share": None}]


def k2_split_ms(fns) -> dict:
    """Device milliseconds per call of each K2 CUDA kernel (any kernel
    whose name holds ``bn_sums`` but not ``backward``), from torch.profiler
    over the calls ``fns``; {} when the trace holds none (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import pad_trace_start

    fns[0]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_trace_start()
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        name = re.search(r"\w*bn_sums\w*", ev.key)
        us = getattr(ev, "self_device_time_total", 0.0)
        if name and "backward" not in name.group() and us:
            key = name.group()
            split[key] = split.get(key, 0.0) + us / 1e3 / len(fns)
    return split


def pose_resnet_batch():
    """PoseResNet-50 in bf16, channels_last, on the card, and a batch of 32
    random 256 px images (NHWC), from SEED."""
    import torch

    from mmhand_torch.models.check_nets import make_test_pose_resnet

    size = FULL["size"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = make_test_pose_resnet(POSE["size"], torch.bfloat16, SEED).to(
        device="cuda", memory_format=torch.channels_last)
    x = torch.rand(POSE["batch"], size, size, 3, generator=gen,
                   device="cuda") * 2 - 1
    return net, x, gen


def pose_resnet_bn_inputs(net, x) -> list:
    """The inputs of the net's 56 BatchNorms in one train-mode forward of
    ``x`` (without autograd)."""
    import torch

    from mmhand_torch.models.layers import BatchNorm2d

    inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[0].detach()))
        for m in net.modules() if isinstance(m, BatchNorm2d)]
    net.train()
    with torch.no_grad():
        net(x)
    for h in hooks:
        h.remove()
    check(len(inputs) == POSE["bn_sites"], f"{len(inputs)} BatchNorm inputs")
    return inputs


def bn_site_phase(rounds: int = 2) -> dict:
    """K2 per call at the main paths' sites by ``graph_ms`` (GRAPH_CALLS
    calls in one CUDA graph, cycling over enough copies of the input to
    outgrow the L2 cache, so that each call reads HBM as its bound
    assumes), beside the profiler's time per CUDA kernel (first round
    only), the bound, the share of the bound and ``torch.batch_norm_stats``
    timed the same way:
    the GAN step's four shapes (and K2 per step over its 101 calls), the
    MSRA/V2V C=1, C=21 and largest 5-D sites, and PoseResNet-50's 56
    inputs summed.  ``rounds`` repeats of the timing show the spread.
    Returns the last round's K2 milliseconds by site."""
    import torch

    from benchmark import roofline
    from mmhand_torch.ops.bn_stats import bn_sums

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(shape, dtype):
        layout = (torch.channels_last if len(shape) == 4
                  else torch.channels_last_3d)
        nbytes = math.prod(shape) * torch.finfo(dtype).bits // 8
        copies = min(GRAPH_CALLS, math.ceil(2 * L2_BYTES / nbytes))
        return [(torch.randn(shape, generator=gen, device="cuda") * 1.5 + 0.3
                 ).to(dtype).contiguous(memory_format=layout)
                for _ in range(copies)]

    def cycle(fn, xs):
        return [functools.partial(fn, xs[i % len(xs)])
                for i in range(GRAPH_CALLS)]

    def k2_bound(x):
        return roofline.k2_bound_s(x.numel(), x.element_size(),
                                   x.shape[1]) * 1e3

    sites = [(f"GAN x{calls}", shape, torch.bfloat16, calls)
             for shape, calls in GAN_BN_SITES]
    sites += [("MSRA/V2V", shape, torch.float32, 0) for shape in MSRA_BN_TIMED]
    data = [(what, inputs(shape, dtype), calls)
            for what, shape, dtype, calls in sites]
    net, images, pose_gen = pose_resnet_batch()
    pose = pose_resnet_bn_inputs(net, images)
    weights = torch.randn(POSE["batch"], FULL["size"] // 4,
                          FULL["size"] // 4, 21, generator=pose_gen,
                          device="cuda")

    def train_pass():
        net.zero_grad(set_to_none=True)
        (net(images) * weights).sum().backward()

    library = functools.partial(torch.batch_norm_stats, eps=1e-5)
    result = {}
    for round_ in range(1, rounds + 1):
        step_ms = step_lib = step_bound = 0.0
        for what, xs, calls in data:
            x = xs[0]
            ms = graph_ms(cycle(bn_sums, xs))
            lib = graph_ms(cycle(library, xs))
            split = k2_split_ms(cycle(bn_sums, xs)) if round_ == 1 else {}
            b = k2_bound(x)
            step_ms += calls * ms
            step_lib += calls * lib
            step_bound += calls * b
            result[f"{tuple(x.shape)} {x.dtype}"] = ms
            parts = (", ".join(f"{k} {v:.4f}" for k, v in split.items())
                     or ("not measured" if round_ == 1 else "round 1 only"))
            print(f"K2 site, round {round_}: {what} {tuple(x.shape)} "
                  f"{str(x.dtype).removeprefix('torch.')} "
                  f"({x.numel() * x.element_size() / 1e6:.1f} MB, "
                  f"{len(xs)} copies): {ms:.4f} ms per call (CUDA graph of "
                  f"{GRAPH_CALLS}), bound {b:.4f} ms ({100 * b / ms:.1f}%); "
                  f"profiler split {parts} ms; torch.batch_norm_stats "
                  f"{lib:.4f} ms ({100 * b / lib:.1f}%)")
        print(f"K2 per GAN step, round {round_} ({BN_PER_STEP} calls over "
              f"the four sites): {step_ms:.4f} ms, bound {step_bound:.4f} ms "
              f"({100 * step_bound / step_ms:.1f}%); torch.batch_norm_stats "
              f"{step_lib:.4f} ms")
        ms = graph_ms([functools.partial(bn_sums, t) for t in pose]) * len(pose)
        lib = graph_ms([functools.partial(library, t) for t in pose]) * len(pose)
        b = sum(k2_bound(t) for t in pose)
        result["PoseResNet-50"] = ms
        print(f"K2 over PoseResNet-50's {len(pose)} BatchNorm inputs, round "
              f"{round_} (batch {POSE['batch']}, bf16, "
              f"{sum(t.numel() * t.element_size() for t in pose) / 1e9:.3f} "
              f"GB): {ms:.4f} ms (CUDA graph of the {len(pose)} calls), "
              f"bound {b:.4f} ms ({100 * b / ms:.1f}%); "
              f"torch.batch_norm_stats {lib:.4f} ms")
        # where the host sets the pace: the wrapper's host work, and the
        # PoseResNet-50 train pass that runs K2 and K2b at its 56 sites
        small = next(xs[0] for _, xs, _ in data
                     if xs[0].shape == MSRA_BN_TIMED[1])
        wrapper_us = host_us(lambda: bn_sums(small))
        pass_ms = cuda_ms(train_pass, iters=5, warmup=1)
        print(f"K2's wrapper, round {round_}: {wrapper_us:.2f} us of host work "
              f"per call at {tuple(small.shape)} (host clock); PoseResNet-50 "
              f"train-mode forward and backward at batch {POSE['batch']}: "
              f"{pass_ms:.3f} ms (CUDA events, median of 5)")
    return result


def bn_apply_bounds(x) -> tuple[float, float]:
    """Least milliseconds of the normalize at ``x``, forward and backward:
    x read and y written, or x and dy read and dx written, plus the
    per-channel f32 vectors; 3 f32 operations an element forward (subtract,
    multiply, add), 5 backward (subtract, two multiply-adds, a multiply)."""
    n, e, c = x.numel(), x.element_size(), x.shape[1]
    return (bound(2 * n * e + 4 * c * 4, 3 * n)[0],
            bound(3 * n * e + 7 * c * 4, 5 * n)[0])


def bn_apply_errors(x, dy, mean, mean_sq, weight, bias, eps) -> dict:
    """The normalize's kernels on ``x`` against the plain version on the
    card: the relative errors of y and dx, against the plain version's
    largest |value|, and of the four per-channel gradients, against the
    sums of |terms| they come from (K2's rule: f32 sums in another order)."""
    import torch

    from mmhand_torch.ops.bn_stats import (
        bn_apply_backward,
        bn_apply_backward_ref,
        bn_apply_forward,
        bn_apply_ref,
    )

    y = bn_apply_forward(x, mean, mean_sq, weight, bias, eps).float()
    got = bn_apply_backward(dy, x, mean, mean_sq, weight, eps)
    y_ref = bn_apply_ref(x, mean, mean_sq, weight, bias, eps).float()
    want = bn_apply_backward_ref(dy, x, mean, mean_sq, weight, eps)
    axes, ch = (0,) + tuple(range(2, x.dim())), (1, -1) + (1,) * (x.dim() - 2)
    r = torch.rsqrt(torch.clamp(mean_sq - mean * mean, min=0.0) + eps)
    g = dy.float()
    abs_dy = g.abs().sum(axes)
    abs_b = (g * (x.float() - mean.view(ch))).abs().sum(axes)
    d_var = 0.5 * weight.abs() * r ** 3
    terms = ((r * weight).abs() * abs_dy + 2 * mean.abs() * d_var * abs_b,
             d_var * abs_b, r * abs_b, abs_dy)
    dx, dx_ref = got[0].float(), want[0].float()
    return {"y": float((y - y_ref).abs().max() / y_ref.abs().max()),
            "dx": float((dx - dx_ref).abs().max() / dx_ref.abs().max()),
            "gradients": max(float(((a - b).abs() / t).max())
                             for a, b, t in zip(got[1:], want[1:], terms))}


def device_launches(fn) -> int:
    """Device activities (kernels, copies, memsets) one call of ``fn`` puts
    on the card, by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import PAD_KERNEL, pad_trace_start

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_trace_start()
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and PAD_KERNEL not in ev.key)


def bn_apply_phase() -> list:
    """bn_apply_kernel and bn_apply_backward_kernel (the train-mode
    normalize) at the GAN step's four site shapes in bf16, the largest also
    in f16 and f32, and the MSRA/V2V group's C=1, C=21 and largest 5-D
    sites in f32, timed by ``graph_ms`` over copies past the L2 beside the
    profiler's device time, the bound, the plain version's CUDA-event time,
    and torch's own BatchNorm kernels doing the same work
    (``torch.batch_norm_elemt`` forward; ``batch_norm_backward_reduce``, a
    multiply for dx and the per-channel ops backward), by graph and by CUDA
    events with their launches; summed per GAN step over its 101 calls.
    Returns the two kernels' records at the largest site."""
    import torch

    from mmhand_torch.ops.bn_stats import (
        bn_apply_backward,
        bn_apply_backward_ref,
        bn_apply_forward,
        bn_apply_ref,
        bn_sums_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    eps = 1e-5

    def case(shape, dtype, copies):
        layout = (torch.channels_last if len(shape) == 4
                  else torch.channels_last_3d)
        xs, dys = [], []
        for _ in range(copies):
            xs.append((torch.randn(shape, generator=gen, device="cuda") * 1.5
                       + 0.3).to(dtype).contiguous(memory_format=layout))
            dys.append(torch.randn(shape, generator=gen, device="cuda").to(
                dtype).contiguous(memory_format=layout))
        n = xs[0].numel() // shape[1]
        s1, s2 = bn_sums_ref(xs[0])
        weight = 1 + 0.02 * torch.randn(shape[1], generator=gen, device="cuda")
        bias = 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        return xs, dys, (s1 / n, s2 / n, weight, bias)

    def library_forward(x, stats):
        """torch's BatchNorm kernel for the normalize: y and invstd."""
        mean, mean_sq, weight, bias = stats
        invstd = torch.rsqrt(torch.clamp(mean_sq - mean * mean, min=0.0)
                             + eps)
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)

    def library_backward(x, dy, stats):
        """torch's BatchNorm kernels for the backward: the per-channel
        sums and d_weight, d_bias in one pass, dx = dy * scale in x's type,
        d_mean and d_mean_sq from the sums."""
        mean, mean_sq, weight, _ = stats
        raw = mean_sq - mean * mean
        invstd = torch.rsqrt(torch.clamp(raw, min=0.0) + eps)
        sum_dy, sum_dy_xmu, d_weight, d_bias = (
            torch.batch_norm_backward_reduce(dy, x, mean, invstd, weight,
                                             True, True, True))
        scale = invstd * weight
        dx = torch.mul(dy, scale.view((1, -1) + (1,) * (x.dim() - 2)),
                       out=torch.empty_like(x))
        d_var = torch.where(raw >= 0, -0.5 * (sum_dy_xmu * weight)
                            * invstd ** 3, 0.0)
        return dx, -(scale * sum_dy) - 2.0 * mean * d_var, d_var, d_weight, \
            d_bias

    sites = [(f"GAN x{calls}", shape, torch.bfloat16, calls)
             for shape, calls in GAN_BN_SITES]
    sites += [("GAN largest, f16", GAN_BN_SITES[0][0], torch.float16, 0),
              ("GAN largest, f32", GAN_BN_SITES[0][0], torch.float32, 0)]
    sites += [("MSRA/V2V", shape, torch.float32, 0)
              for shape in MSRA_BN_TIMED[:4:2] + MSRA_BN_TIMED[3:]]
    step = {k: 0.0 for k in ("forward", "backward", "bound", "library",
                             "eager", "library_eager")}
    records = []
    for what, shape, dtype, calls in sites:
        nbytes = math.prod(shape) * torch.finfo(dtype).bits // 8
        xs, dys, stats = case(shape, dtype,
                              min(GRAPH_CALLS, math.ceil(L2_BYTES / nbytes) + 1))
        x, dy = xs[0], dys[0]
        pick = [(xs[i % len(xs)], dys[i % len(xs)])
                for i in range(GRAPH_CALLS)]
        fwd = [functools.partial(bn_apply_forward, a, *stats, eps)
               for a, _ in pick]
        bwd = [functools.partial(bn_apply_backward, b, a, *stats[:3], eps)
               for a, b in pick]
        lib_fwd = [functools.partial(library_forward, a, stats)
                   for a, _ in pick]
        lib_bwd = [functools.partial(library_backward, a, b, stats)
                   for a, b in pick]
        fwd_ms, bwd_ms = graph_ms(fwd), graph_ms(bwd)
        lib_ms = (graph_ms(lib_fwd), graph_ms(lib_bwd))
        fwd_dev = kernel_device_ms(fwd[0], BN_APPLY_KERNELS)
        bwd_dev = kernel_device_ms(bwd[0], BN_APPLY_BWD_KERNELS)
        fwd_bound, bwd_bound = bn_apply_bounds(x)
        plain = cuda_ms(lambda: bn_apply_ref(x, *stats, eps), iters=5)
        plain_bwd = cuda_ms(lambda: bn_apply_backward_ref(
            dy, x, *stats[:3], eps), iters=5)
        eager = cuda_ms(lambda: (bn_apply_forward(x, *stats, eps),
                                 bn_apply_backward(dy, x, *stats[:3], eps)),
                        iters=5)
        lib_eager = cuda_ms(lambda: (library_forward(x, stats),
                                     library_backward(x, dy, stats)), iters=5)
        ours_n = device_launches(lambda: (
            bn_apply_forward(x, *stats, eps),
            bn_apply_backward(dy, x, *stats[:3], eps)))
        lib_n = device_launches(lambda: (library_forward(x, stats),
                                         library_backward(x, dy, stats)))
        for k, v in (("forward", fwd_ms), ("backward", bwd_ms),
                     ("bound", fwd_bound + bwd_bound), ("library", sum(lib_ms)),
                     ("eager", eager), ("library_eager", lib_eager)):
            step[k] += calls * v
        print(f"bn_apply {what} {shape} {str(dtype).removeprefix('torch.')} "
              f"({nbytes / 1e6:.1f} MB, {len(xs)} copies): forward "
              f"{fwd_ms:.4f} ms (graph; "
              f"profiler {fwd_dev:.4f}), bound {fwd_bound:.4f} ms "
              f"({100 * fwd_bound / fwd_ms:.1f}%), plain {plain:.4f} ms; "
              f"backward {bwd_ms:.4f} ms (graph; profiler {bwd_dev:.4f}), "
              f"bound {bwd_bound:.4f} ms ({100 * bwd_bound / bwd_ms:.1f}%), "
              f"plain {plain_bwd:.4f} ms; forward and backward: kernels "
              f"{fwd_ms + bwd_ms:.4f} ms (graph), {eager:.4f} ms eager, "
              f"{ours_n} launches; torch's BatchNorm kernels {lib_ms[0]:.4f} + "
              f"{lib_ms[1]:.4f} ms (graph), {lib_eager:.4f} ms eager, "
              f"{lib_n} launches")
        if not records:
            rel = bn_apply_errors(x, dy, *stats, eps)
            unit = torch.finfo(dtype).eps
            check(rel["y"] <= 4 * unit and rel["dx"] <= 4 * unit
                  and rel["gradients"] <= 2e-5,
                  f"bn_apply {shape}: relative errors {rel}")
            print(f"bn_apply {shape} {dtype} against the plain version: "
                  f"relative errors {rel}")
            records = [
                {"name": "bn_apply", "route": "cuda", "source": BN_SOURCE,
                 "replaces": None, "max_abs_err": None,
                 "max_rel_err": rel["y"], "ms": fwd_ms, "plain_ms": plain,
                 "bound_ms": fwd_bound, "bound_by": "bytes",
                 "library_ms": lib_ms[0], "device_ms": fwd_dev,
                 "skipped_share": None},
                {"name": "bn_apply_backward", "route": "cuda",
                 "source": BN_SOURCE, "replaces": None, "max_abs_err": None,
                 "max_rel_err": max(rel["dx"], rel["gradients"]),
                 "ms": bwd_ms, "plain_ms": plain_bwd, "bound_ms": bwd_bound,
                 "bound_by": "bytes", "library_ms": lib_ms[1],
                 "device_ms": bwd_dev, "skipped_share": None}]
        del xs, dys, x, dy, pick, fwd, bwd, lib_fwd, lib_bwd
    print(f"bn_apply per GAN step ({BN_PER_STEP} calls over the four sites): "
          f"forward {step['forward']:.4f} ms, backward {step['backward']:.4f} "
          f"ms (graph), bound {step['bound']:.4f} ms "
          f"({100 * step['bound'] / (step['forward'] + step['backward']):.1f}%)"
          f"; torch's BatchNorm kernels {step['library']:.4f} ms (graph); "
          f"eager with launches: kernels {step['eager']:.4f} ms, torch's "
          f"{step['library_eager']:.4f} ms")
    reset_launches()  # the kernels ran here without K2 beside them
    return records


def reflect_pad_bytes(shape, elem_bytes: int, p: int) -> int:
    """Bytes the pad moves each way at an input of ``shape``: x read and y
    written forward, dy read and dx written backward."""
    b, c, h, w = shape
    return b * c * (h * w + (h + 2 * p) * (w + 2 * p)) * elem_bytes


def reflect_pad_phase() -> list:
    """reflect_pad_kernel and reflect_pad_backward_kernel at each pad site
    of the GAN step (``GAN_PAD_SITES``), timed by ``graph_ms`` over copies
    past the L2 beside the bound (bytes), and summed per step.  At the
    blocks' site, (16, 256, 64, 64) bf16, the kernel table's row: also the
    profiler's device time and the CUDA-event time, the plain version
    (ATen's pad and its backward) by CUDA events, and what the step ran
    there before (nn.ReflectionPad2d and the copy of its NCHW output to
    channels_last; ATen's backward and the copy of its NCHW gradient) by
    graph; the forward held bit for bit against ATen's pad, the backward
    within one rounding of its type of ATen's backward in f32, and bit for
    bit on a second call.  Returns the two kernels' records there."""
    import torch
    from torch import nn

    from mmhand_torch.ops.reflect_pad import (
        reflect_pad_backward_cuda,
        reflect_pad_forward_cuda,
        reflect_pad_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def nhwc(shape, dtype):
        b, c, h, w = shape
        return torch.randn(b, h, w, c, generator=gen, device="cuda").to(
            dtype).permute(0, 3, 1, 2)

    def aten_backward(x, dy, p):
        return torch.ops.aten.reflection_pad2d_backward(dy, x, [p] * 4)

    def library_forward(pad, x):
        return pad(x).contiguous(memory_format=torch.channels_last)

    def library_backward(x, dy, p):
        return aten_backward(x, dy, p).contiguous(
            memory_format=torch.channels_last)

    block = GAN_PAD_SITES[4]
    step = {"forward": 0.0, "backward": 0.0, "bound": 0.0}
    records = []
    for shape, dtype, p, n_fwd, n_bwd in GAN_PAD_SITES:
        at_block = (shape, dtype) == block[:2]
        dtype = getattr(torch, dtype)
        nbytes = reflect_pad_bytes(shape, dtype.itemsize, p)
        copies = min(GRAPH_CALLS, math.ceil(2 * L2_BYTES / nbytes) + 1)
        padded = shape[:2] + (shape[2] + 2 * p, shape[3] + 2 * p)
        xs = [nhwc(shape, dtype) for _ in range(copies)]
        dys = [nhwc(padded, dtype) for _ in range(copies)]
        pick = [(xs[i % copies], dys[i % copies]) for i in range(GRAPH_CALLS)]
        fwd = [functools.partial(reflect_pad_forward_cuda, a, p)
               for a, _ in pick]
        bwd = [functools.partial(reflect_pad_backward_cuda, b, p)
               for _, b in pick]
        fwd_ms, bwd_ms = graph_ms(fwd), graph_ms(bwd)
        bound_ms = bound(nbytes, 0)[0]
        step["forward"] += n_fwd * fwd_ms
        step["backward"] += n_bwd * bwd_ms
        step["bound"] += (n_fwd + n_bwd) * bound_ms
        print(f"reflect_pad x{n_fwd}/{n_bwd} a step {shape} p{p} "
              f"{str(dtype).removeprefix('torch.')} ({nbytes / 1e6:.1f} MB "
              f"each way, {copies} copies): forward {fwd_ms:.4f} ms, backward "
              f"{bwd_ms:.4f} ms (graph), bound {bound_ms:.4f} ms each "
              f"({100 * bound_ms / fwd_ms:.1f}%, "
              f"{100 * bound_ms / bwd_ms:.1f}%)")
        if at_block:
            x, dy = xs[0], dys[0]
            y, dx = fwd[0](), bwd[0]()
            y_err = float((y.float() - reflect_pad_ref(x, p).float()).abs()
                          .max())
            want = aten_backward(x.float(), dy.float(), p)
            total = aten_backward(x.float(), dy.float().abs(), p)
            dx_err = float((dx.float() - want).abs().max())
            within = bool(((dx.float() - want).abs()
                           <= torch.finfo(dtype).eps / 2 * want.abs()
                           + 5 * torch.finfo(torch.float32).eps * total)
                          .all())
            check(y_err == 0 and within and torch.equal(bwd[0](), dx),
                  f"reflect_pad {shape}: {y_err} from ATen's pad, {dx_err} "
                  f"from ATen's backward in f32 (within one rounding: "
                  f"{within}), or a second backward differs")
            pad = nn.ReflectionPad2d(p)
            library = (
                graph_ms([functools.partial(library_forward, pad, a)
                          for a, _ in pick]),
                graph_ms([functools.partial(library_backward, a, b, p)
                          for a, b in pick]))
            device = (kernel_device_ms(fwd[0], PAD_KERNELS),
                      kernel_device_ms(bwd[0], PAD_BWD_KERNELS))
            events = (cuda_ms(fwd[0]), cuda_ms(bwd[0]))
            plain = (cuda_ms(lambda: reflect_pad_ref(x, p), iters=5),
                     cuda_ms(lambda: aten_backward(x, dy, p), iters=5))
            print(f"reflect_pad {shape} {dtype}: forward / backward device "
                  f"{device[0]:.4f} / {device[1]:.4f} ms (profiler), "
                  f"{events[0]:.4f} / {events[1]:.4f} ms a call (CUDA "
                  f"events, the wrapper's host work included); plain "
                  f"(ATen's pad) {plain[0]:.4f} / {plain[1]:.4f} ms (CUDA "
                  f"events); before (nn.ReflectionPad2d and the layout "
                  f"copies) {library[0]:.4f} / {library[1]:.4f} ms (graph); "
                  f"forward bit for bit, backward {dx_err:.3g} from ATen's "
                  f"in f32 and bit for bit on a second call")
            records = [
                {"name": "reflect_pad", "route": "cuda", "source": PAD_SOURCE,
                 "replaces": None, "max_abs_err": y_err, "max_rel_err": None,
                 "ms": fwd_ms, "plain_ms": plain[0], "bound_ms": bound_ms,
                 "bound_by": "bytes", "library_ms": library[0],
                 "device_ms": device[0], "skipped_share": None},
                {"name": "reflect_pad_backward", "route": "cuda",
                 "source": PAD_SOURCE, "replaces": None, "max_abs_err": dx_err,
                 "max_rel_err": None, "ms": bwd_ms, "plain_ms": plain[1],
                 "bound_ms": bound_ms, "bound_by": "bytes",
                 "library_ms": library[1], "device_ms": device[1],
                 "skipped_share": None}]
        del xs, dys, pick, fwd, bwd
    print(f"reflect_pad per GAN step ({PAD_PER_STEP[0]} forward, "
          f"{PAD_PER_STEP[1]} backward calls): forward {step['forward']:.4f} "
          f"ms, backward {step['backward']:.4f} ms (graph), bound "
          f"{step['bound']:.4f} ms "
          f"({100 * step['bound'] / (step['forward'] + step['backward']):.1f}"
          f"%)")
    reset_launches()  # the kernels ran here outside any path
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


def slice_phase(tmp: Path) -> dict:
    """The full-width generation path through aug.main; returns the
    kernels' launches there."""
    import torch

    from mmhand_torch.config import Config, DataConfig, ModelConfig
    from mmhand_torch.data import make_prepare_batch
    from mmhand_torch.ops.image import denormalize_image
    from mmhand_torch.scripts import aug
    from mmhand_torch.train.state import build_generator
    from mmhand_torch.train.step import make_eval_step
    from mmhand_torch.utils.checkpoint import save_network
    from mmhand_torch.utils.png import read_png

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
    reset_launches()
    with contextlib.redirect_stdout(out):
        written = aug.main(argv)
    launches = kernel_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(out.getvalue().strip())
    files = sorted((dst / "tgt").glob("*.png"))
    check(written == n_items and len(files) == n_items,
          f"{written} written, {len(files)} PNGs on disk, {n_items} expected")
    batches = n_items // gen_batch
    check(launches["gaussian_heatmaps"] == 2 * batches
          and {k: launches[k] for k in pad_launches(0, 0)}
          == pad_launches(G_PAD_SITES * batches, 0),
          f"launches in the slice: {launches}")
    check(re.search(r"([0-9.]+) images/s after the first batch",
                    out.getvalue()) is not None, "aug printed no steady rate")
    print(f"slice: {written} fakes, peak device memory {peak_gib:.2f} GiB, "
          f"launches {launches}")

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
    return launches


def profile_step(fn, what: str, kernels: dict[str, tuple[str, ...]]) -> str:
    """One call of ``fn``, after a warm-up call, in a profiler window
    (``benchmark.trace.profile_window``): the device time and launches of
    the port's kernels (label -> the names of its kernels), of all
    kernels, the device's busy share of the window and the top kernels.  A
    profiler that yields no device time is reported, not failed."""
    from benchmark.trace import Spans, profile_window

    fn()
    prof = profile_window(fn, 1, Spans())
    if not prof.kernels:
        return f"profiled {what}: no device time in the trace (not measured)"
    ours = "".join(f"{k} {1e3 * sec:.4f} ms in {n} launches, " for k, (sec, n)
                   in ((k, prof.kernel_s(*names)) for k, names in kernels.items()))
    total = sum(sec for sec, _ in prof.kernels.values())
    top = "\n".join(f"  {1e3 * sec:9.3f} ms {name[:90]}"
                    for name, sec in prof.top_ops(12))
    return (f"profiled {what}: {ours}all kernels {1e3 * total:.3f} ms of "
            f"{1e3 * prof.window_s:.3f} ms wall (device busy "
            f"{100 * prof.busy_s / prof.window_s:.1f}%); top kernels:\n{top}")


def train_slice_phase(tmp: Path) -> dict:
    """The full-width train step through scripts.train.main, then its
    checkpoint through aug.main; returns the kernels' launches in the train
    run."""
    import math
    import warnings

    import torch

    from mmhand_torch.scripts import aug
    from mmhand_torch.scripts import train as train_script
    from mmhand_torch.train.state import build_system

    steps, batch_size = TRAIN["steps"], TRAIN["batch"]
    size = FULL["size"]
    ckpt = tmp / "train_ckpt"
    argv = ["--dataset", "synthetic", "--batchSize", str(batch_size),
            "--fineSize", str(size), "--max_steps", str(steps),
            "--print_freq", "1", "--checkpoints_dir", str(ckpt),
            "--name", "train_smoke", "--device", "cuda"]
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with warnings.catch_warnings(), contextlib.redirect_stdout(out):
        warnings.simplefilter("ignore")  # the random-VGG warning
        result = train_script.main(argv)
    launches = kernel_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(out.getvalue().strip())

    cfg = result.system.config
    check(cfg.model.ngf == 64 and cfg.model.g_n_blocks == 9
          and cfg.model.n_layers_d == 3 and cfg.model.norm == "batch"
          and cfg.precision.compute_dtype == "bfloat16"
          and cfg.optim.pool_size == 50 and cfg.optim.dg_ratio == 1
          and cfg.loss.l1_type == "l1_plus_perL1", "flagship train config")
    check(result.steps == steps, f"{result.steps} steps taken")
    check(launches["bn_sums"] == BN_PER_STEP * steps
          and launches["bn_sums_backward"] == BN_PER_STEP * steps
          and launches["gaussian_heatmaps"] == 2 * steps
          and {k: launches[k] for k in pad_launches(0, 0)}
          == pad_launches(PAD_PER_STEP[0] * steps, PAD_PER_STEP[1] * steps),
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
    check(result.images_per_sec is not None and result.images_per_sec > 0,
          "train printed no steady rate")

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
    print(f"train slice: {steps} steps at batch {batch_size}, peak device "
          f"memory {peak_gib:.2f} GiB, launches {launches}")

    # the trained generator's checkpoint drives the generation path
    written = aug.main(["--dataset", "synthetic", "--fineSize", str(size),
                        "--max_dataset_size", str(batch_size),
                        "--gen_batch", str(batch_size),
                        "--checkpoints_dir", str(ckpt), "--name", "train_smoke",
                        "--dst", str(tmp / "train_fakes"), "--device", "cuda"])
    check(written == batch_size, f"aug wrote {written} fakes from the trained G")
    return launches


def kernel_launches() -> dict:
    """The launches of the port's kernels since the counters of
    ``utils.trace`` were last reset, by their wrappers' names."""
    from mmhand_torch.scripts import train

    return train.kernel_launches(tuple(train.LAUNCH_COUNTERS))


def bn_launches(forward: int, backward: int) -> dict:
    """The launches of K2 and K2b, and of the normalize's two kernels beside
    them, where ``forward`` train-mode BatchNorm calls ran and ``backward``
    of them took a gradient."""
    return {"bn_sums": forward, "bn_sums_backward": backward,
            "bn_apply": forward, "bn_apply_backward": backward}


def pad_launches(forward: int, backward: int) -> dict:
    """The launches of the reflect pad and its backward."""
    return {"reflect_pad": forward, "reflect_pad_backward": backward}


def reset_launches() -> None:
    """Set the counters of ``utils.trace`` back to nothing."""
    from mmhand_torch.utils import trace

    trace.reset()


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
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with warnings.catch_warnings(), contextlib.redirect_stdout(out):
        warnings.simplefilter("ignore")  # the random-VGG warning
        result = train(cfg, device="cuda", max_steps=steps)
    launches = kernel_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    system = result.system
    check(result.steps == steps and system.step == steps,
          f"fp16: {result.steps} steps taken")
    check(launches["bn_sums"] == BN_PER_STEP * steps
          and launches["bn_sums_backward"] == BN_PER_STEP * steps
          and launches["gaussian_heatmaps"] == 2 * steps
          and {k: launches[k] for k in pad_launches(0, 0)}
          == pad_launches(PAD_PER_STEP[0] * steps, PAD_PER_STEP[1] * steps),
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
    --continue_train.  Returns the kernels' launches in the two runs."""
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
    steps = 2 * RESUME_STEPS
    check({k: launches[k] for k in (*bn_launches(0, 0), *pad_launches(0, 0))}
          == {**bn_launches(BN_PER_STEP * steps, BN_PER_STEP * steps),
              **pad_launches(PAD_PER_STEP[0] * steps,
                             PAD_PER_STEP[1] * steps)},
          f"resume launches {launches}")
    print(f"resume: state_latest.pt {nbytes} bytes, {n_tensors} tensors "
          f"restored bit for bit; save {save_s:.3f} s, restore {restore_s:.3f} "
          f"s; the resumed run reached step {2 * RESUME_STEPS}; launches "
          f"{launches}")
    return launches


def toy_config():
    """The dry run's toy GAN (``parallel.dryrun.toy_config``) in float32,
    dropout off, pool 0: one step is then the same on any split of the
    batch."""
    from mmhand_torch.config import (
        Config,
        DataConfig,
        ModelConfig,
        OptimConfig,
        PrecisionConfig,
    )

    return Config(model=ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=2,
                                    n_layers_d=2, use_dropout_g=False,
                                    use_dropout_d=False),
                  optim=OptimConfig(pool_size=0),
                  data=DataConfig(dataset="synthetic", seed=SEED),
                  precision=PrecisionConfig(compute_dtype="float32"))


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
        reset_launches()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            result = train(cfg, device=device, max_steps=RESUME_STEPS,
                           distributed=True)
        launches = kernel_launches()
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


def nccl_phase(tmp: Path) -> dict:
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
          and launches["bn_sums_backward"] == BN_PER_STEP * RESUME_STEPS
          and {k: launches[k] for k in pad_launches(0, 0)}
          == pad_launches(PAD_PER_STEP[0] * RESUME_STEPS,
                          PAD_PER_STEP[1] * RESUME_STEPS),
          f"NCCL world 1 launches {launches}")
    print(f"NCCL world size 1 (torchrun, {seconds:.1f} s with start-up): "
          f"{RESUME_STEPS} flagship steps, {r['images_per_sec']} images/s after "
          f"the first; one step {r['step_ms']:.3f} ms by CUDA events; "
          f"{r['all_reduces_per_step']} all-reduces per step; launches "
          f"{launches}")
    return launches


def hpe_toy_config():
    """The dry run's HPE trainer (32 px, full-width CPM nets) in float32."""
    from mmhand_torch.config import Config, ModelConfig, PrecisionConfig

    return Config(model=ModelConfig(fine_size=32),
                  precision=PrecisionConfig(compute_dtype="float32"))


def lifting_system(distributed: bool = False):
    """The dry run's hand3d lifting net (proposed, crop 32) on the card,
    its dropout off (keep 1: every element kept and divided by 1)."""
    from mmhand_torch.hand3d import Hand3DSystem

    system = Hand3DSystem("lifting", "proposed", crop_size=32, device="cuda",
                          seed=3, distributed=distributed)
    system.module.PosePrior.KEEP = system.module.ViewpointNet.KEEP = 1.0
    return system


def gloo_legs(rank: int, world: int, distributed: bool) -> dict:
    """The three toy DP steps of ``parallel.dryrun`` on the card (f32, TF32
    off, dropout off, pool 0), on rank ``rank``'s items of the global batch
    (all of them for world 1): {leg: (metrics, network state_dicts)}."""
    import warnings

    import torch

    from mmhand_torch.hand3d import make_hand3d_train_step
    from mmhand_torch.hpe import HPESystem, make_hpe_train_step
    from mmhand_torch.parallel.dryrun import hand3d_batch, hpe_batch, toy_batch
    from mmhand_torch.train.state import build_system
    from mmhand_torch.train.step import make_train_step

    mine = slice(2 * rank, 2 * rank + 2) if world > 1 else slice(None)

    def cuda(batch):
        return {k: torch.from_numpy(v[mine]).cuda() for k, v in batch.items()}

    cfg = toy_config()
    legs = {}
    with tf32_off(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gan = build_system(cfg, "cuda", distributed=distributed)
        metrics = make_train_step(gan)(cuda(toy_batch(4)), cfg.optim.lr)
        legs["gan"] = ({k: float(v) for k, v in metrics.items()},
                       {n: getattr(gan, n).state_dict()
                        for n in ("generator", "d_pb", "d_pp")})
        del gan
        hpe = HPESystem(hpe_toy_config(), "hpm", "cuda",
                        distributed=distributed)
        metrics = make_hpe_train_step(hpe)(cuda(hpe_batch(4)),
                                           hpe.config.optim.lr)
        legs["hpe"] = ({k: float(v) for k, v in metrics.items()},
                       {n: getattr(hpe, n).state_dict()
                        for n in ("hpm2d", "hpm3d")})
        del hpe
        lift = lifting_system(distributed)
        loss = make_hand3d_train_step(lift)(cuda(hand3d_batch(4)))
        legs["hand3d"] = ({"loss": float(loss)},
                          {"lifting": lift.module.state_dict()})
    return legs


def gloo_worker(out: str) -> None:
    """One of two ranks on the one card over gloo: the three toy DP steps
    (``gloo_legs``) on this rank's half of the batch; rank 0 saves the
    networks, the metrics and the kernels' launches."""
    import torch
    import torch.distributed as dist

    from mmhand_torch.parallel import init_distributed

    init_distributed("cpu")  # gloo, with the tensors on the card
    try:
        rank = dist.get_rank()
        reset_launches()
        legs = gloo_legs(rank, dist.get_world_size(), True)
        if rank == 0:
            torch.save({"legs": legs,
                        "launches": kernel_launches()}, out)
    finally:
        dist.destroy_process_group()


def gloo_phase(tmp: Path) -> dict:
    """Two ranks on the one card over gloo, the GAN, HPE (hpm) and hand3d
    lifting DP steps, each against the single-process step on the full batch
    on the card; returns rank 0's kernel launches."""
    import torch

    from mmhand_torch.hand3d.system import TRAIN_PARA_LIFTING
    from mmhand_torch.parallel.dryrun import launch, params_agree

    out = tmp / "gloo.pt"
    start = time.perf_counter()
    launch([str(ROOT / "chip_smoke.py"), "--gloo-worker", str(out)], 2,
           timeout=300)
    seconds = time.perf_counter() - start
    r = torch.load(out, weights_only=True)
    start = time.perf_counter()
    want = gloo_legs(0, 1, False)
    single_s = time.perf_counter() - start
    lrs = {"gan": toy_config().optim.lr, "hpe": hpe_toy_config().optim.lr,
           "hand3d": TRAIN_PARA_LIFTING["lr"][0]}
    summary = []
    for leg, (metrics, nets) in want.items():
        got_metrics, got_nets = r["legs"][leg]
        for k, v in metrics.items():
            check(abs(got_metrics[k] - v) <= 2e-4 * (1 + abs(v)),
                  f"gloo DP {leg} loss {k}: {got_metrics[k]} against {v}")
        agree = []
        for n, sd in nets.items():
            ok, line = params_agree(got_nets[n], sd, 1, lrs[leg])
            check(ok, f"gloo DP {leg} {n}: {line}")
            agree.append(f"{leg} {n} {line}")
        agree = "; ".join(agree)
        summary.append(f"{leg}: {got_metrics} against {metrics}; {agree}")
    print(f"two ranks on the card over gloo ({seconds:.1f} s with start-up; "
          f"the three single-process steps {single_s:.1f} s): one toy DP "
          f"step of each leg against its full-batch step: "
          + " | ".join(summary) + f"; rank 0 launches {r['launches']}")
    return r["launches"]


def longrun_phase(tmp: Path) -> dict:
    """``mmhand_torch.scripts.longrun_demo`` at the flagship's width: leg 1
    killed by SIGKILL past a save point, leg 2 resumed from that older
    checkpoint, the JAX tool's three checks at its thresholds, SSIM on the
    trained pairs.  Returns the kernels' launches: leg 2's, as its trainer
    printed them, and the SSIM pass's, counted here."""
    import gc

    import torch

    from mmhand_torch.scripts import longrun_demo

    gc.collect()
    torch.cuda.empty_cache()  # the trainers' processes need the card
    argv = ["--dir", str(tmp / "longrun"), "--device", "cuda",
            "--fineSize", str(FULL["size"]),
            "--batchSize", str(TRAIN["batch"])]
    for k, v in LONGRUN.items():
        argv += [f"--{k}", str(v)]
    reset_launches()
    start = time.perf_counter()
    out = longrun_demo.demo(argv)  # prints the demo's JSON line
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    ssim_launches = kernel_launches()
    leg2, steps2 = out["leg2_launches"], LONGRUN["steps2"]
    every = LONGRUN["save_every"]
    check(out["leg1_returncode"] == -9, f"leg 1 ended with "
          f"{out['leg1_returncode']}, not by SIGKILL")
    check(0 < out["resumed_step"] < out["leg1_last_logged_step"]
          and out["resumed_step"] % every == 0,
          f"leg 2 resumed at step {out['resumed_step']}, leg 1 logged up to "
          f"{out['leg1_last_logged_step']}: not a save point past the kill")
    check(out["final_step"] == out["resumed_step"] + steps2,
          f"leg 2 ended at step {out['final_step']}")
    check(out["continuity_ok"] and out["descent_ok"] and out["plot_ok"],
          f"longrun checks {out}")
    check(out["pair_L1_before_kill"] < 0.7 * out["pair_L1_start"],
          f"the loss before the kill is still near its start, where "
          f"continuity cannot tell a resume from a restart: {out}")
    check(math.isfinite(out["ssim_train_pairs"]), f"SSIM {out}")
    # K1 renders P1 and P2: two launches per step and per SSIM batch
    check(leg2 is not None and leg2["gaussian_heatmaps"] == 2 * steps2
          and {k: leg2.get(k) for k in (*bn_launches(0, 0),
                                        *pad_launches(0, 0))}
          == {**bn_launches(BN_PER_STEP * steps2, BN_PER_STEP * steps2),
              **pad_launches(PAD_PER_STEP[0] * steps2,
                             PAD_PER_STEP[1] * steps2)},
          f"leg 2's launches {leg2}")
    ssim_batches = -(-LONGRUN["items"] // TRAIN["batch"])
    check(ssim_launches["gaussian_heatmaps"] == 2 * ssim_batches
          and {k: ssim_launches[k] for k in pad_launches(0, 0)}
          == pad_launches(G_PAD_SITES * ssim_batches, 0),
          f"the SSIM pass's launches {ssim_launches}")
    print(f"longrun demo ({seconds:.1f} s): leg 1 {out['leg1_seconds']:.1f} s, "
          f"rc {out['leg1_returncode']} after step "
          f"{out['leg1_last_logged_step']}; leg 2 {out['leg2_seconds']:.1f} s "
          f"from step {out['resumed_step']} to {out['final_step']}; "
          f"pair_L1loss {out['pair_L1_start']:.4f} -> "
          f"{out['pair_L1_floor']:.4f}, {out['pair_L1_before_kill']:.4f} "
          f"before the kill, {out['pair_L1_after_resume']:.4f} after, below "
          f"0.7 of the start from step {out['descent_first_step']}; SSIM "
          f"{out['ssim_train_pairs']:.4f}; leg 2 launches {leg2}")
    return {k: v + leg2.get(k, 0) for k, v in ssim_launches.items()}


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

    from benchmark.trace import pad_trace_start

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
    """K3's row of the kernel table on the baselines' evaluation batch (the
    synthetic set's target poses at batch 8, 256 px, as
    ``bench_baselines.jointsmap_condition`` gives them), with the share of
    (pixel, bone) pairs its warp tiles skip."""
    import numpy as np
    import torch

    from mmhand_torch.config import Config, DataConfig, ModelConfig
    from mmhand_torch.ops.jointsmap import generate_jointsmap, generate_jointsmap_ref

    size, nb = FULL["size"], EVAL["baseline_batch"]
    cfg = Config(model=ModelConfig(fine_size=size),
                 data=DataConfig(dataset="synthetic"), is_train=False)
    raw = raw_batch(cfg, nb)
    uv = torch.from_numpy(raw["tgt_uv"])
    z = torch.from_numpy((np.asarray(raw["tgt_z"]) / 700.0 * 255.0
                          ).astype(np.float32))
    uv_d, z_d = uv.cuda(), z.cuda()
    # bit for bit against the CPU (the plain version on the card multiplies
    # by 1/5 where K3 and the CPU divide by 5)
    check(torch.equal(generate_jointsmap(uv_d, z_d, size, size).cpu(),
                      generate_jointsmap_ref(uv, z, size, size)),
          "K3 differs from the plain version on the CPU")
    pairs, near, run = jointsmap_pairs(uv, z, size, size)
    ms = cuda_ms(lambda: generate_jointsmap(uv_d, z_d, size, size))
    device_ms = kernel_device_ms(
        lambda: generate_jointsmap(uv_d, z_d, size, size), K3_KERNELS)
    plain_ms = cuda_ms(lambda: generate_jointsmap_ref(uv_d, z_d, size, size))
    io_bytes = nb * size * size * 4 + uv.numel() * 4 + z.numel() * 4
    # the exact test's 16 f32 operations, for the pairs whose pixel the
    # bone's rectangle does not rule out; beside it, all pairs
    k3_bound, k3_by = bound(io_bytes, K3_OPS_PER_PIXEL_BONE * near)
    all_bound, _ = bound(io_bytes, K3_OPS_PER_PIXEL_BONE * pairs)
    wrapper_us = host_us(lambda: generate_jointsmap(uv_d[:1], z_d[:1], 8, 8))
    print(f"K3 generate_jointsmap on the baselines' batch ({nb}, {size}, "
          f"{size}): pairs {pairs}, not ruled out pixel by pixel {near}, run "
          f"by the warp tiles {run} (skipped {1 - run / pairs:.4f}); kernel "
          f"{ms:.4f} ms per call ({device_ms:.4f} ms of device time, "
          f"profiler; the wrapper's host work {wrapper_us:.1f} us per call at "
          f"(1, 8, 8)), plain {plain_ms:.4f} ms (equal to the CPU's bit for "
          f"bit), bound {k3_bound:.4f} ms ({k3_by}; {all_bound:.4f} ms for "
          f"all pairs); no single PyTorch "
          f"call computes the same function")
    return {"name": "generate_jointsmap", "route": "cuda",
            "source": "mmhand_torch/csrc/jointsmap.cu", "replaces": K3_REPLACES,
            "max_abs_err": 0.0, "max_rel_err": None, "ms": ms, "plain_ms": plain_ms, "bound_ms": k3_bound,
            "bound_by": k3_by, "library_ms": None, "device_ms": device_ms,
            "skipped_share": 1 - run / pairs}


def _run_main(fn, argv):
    """``fn(argv)`` with the kernels' counts set to 0 just before and read
    just after; returns (its result, its stdout, seconds, launches)."""
    import warnings

    import torch

    out = io.StringIO()
    reset_launches()
    start = time.perf_counter()
    with warnings.catch_warnings(), contextlib.redirect_stdout(out):
        warnings.simplefilter("ignore")  # random Inception/CPM/baseline weights
        result = fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = kernel_launches()
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
        pads = {"evaluate_gan": G_PAD_SITES, "bench_baselines resnet":
                RESNET_PAD_SITES, "bench_baselines unet": 0}[what]
        check(launches["generate_jointsmap"] == k3_want
              and launches["gaussian_heatmaps"] == 2 * batches
              and launches["bn_sums"] == launches["bn_sums_backward"] == 0
              and {k: launches[k] for k in pad_launches(0, 0)}
              == pad_launches(pads * batches, 0),
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
                       {"K3": K3_KERNELS}))
    return total


def hpe_train_phase(tmp: Path) -> tuple[dict, Path]:
    """The HPE path at full width through scripts.train_hpe.main on an
    RHD-layout tree (--model hpm, batch 32, 256 px, bf16): losses, nets
    moved, the state saved.  Returns the kernels' launches in the run and
    the tree."""
    import torch

    from mmhand_torch.data.rhd_tree import write_rhd_tree
    from mmhand_torch.hpe import HPESystem
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
            # no epoch saves inside the run (2 steps per epoch); a save is
            # timed below
            "--save_epoch_freq", "10"]
    torch.cuda.reset_peak_memory_stats()
    result, out, _, launches = _run_main(train_hpe.main, argv)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(out)
    system, cfg = result.system, result.system.config
    check(cfg.precision.compute_dtype == "bfloat16" and system.variant == "hpm"
          and cfg.data.augmentation_ratio == 1.0, "HPE config")
    check(result.steps == steps, f"HPE: {result.steps} steps")
    check(launches == {"gaussian_heatmaps": steps, **bn_launches(0, 0),
                       **pad_launches(0, 0), "generate_jointsmap": 0},
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

    check(result.images_per_sec is not None and result.images_per_sec > 0,
          "train_hpe printed no steady rate")

    # one save of the whole train state
    ckpt = CheckpointManager(str(tmp / "hpe_ckpt"), "hpe_smoke")
    start = time.perf_counter()
    ckpt.save(system, "timed")
    save_s = time.perf_counter() - start
    state_bytes = Path(ckpt.path("timed")).stat().st_size
    print(f"HPE train: {steps} steps at batch {batch_size}, peak device "
          f"memory {peak_gib:.2f} GiB, launches {launches}; state_<label>.pt "
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
           "--with_hand3d", "--hand3d_iters", "4",
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
                    if line.startswith(("+ ", "done:", "wrote ", "Training ",
                                        "Average ", "Area "))))
    stages = re.findall(r"^\+ \S+ -m mmhand_torch\.scripts\.(\w+) ", out, re.M)
    check(stages == ["train", "aug", "train_hpe", "test_hpe",
                     "create_hand3d_db", "train_hand3d", "eval_hand3d",
                     "train", "train_hpe", "test_hpe"],
          f"driver stages {stages}")
    # the hand3d judge trains on the generated images' real keypoints: a
    # positive posenet loss (the repaired hand side), a finite EPE and AUC
    h3d_loss = re.findall(r"^Training finished after 4 iterations; final "
                          r"loss (\S+)$", out, re.M)
    check(len(h3d_loss) == 1 and float(h3d_loss[0]) > 0,
          f"hand3d posenet loss {h3d_loss}")
    h3d = re.findall(r"^(?:Average mean EPE|Average median EPE|Area under "
                     r"curve): (\S+)", out, re.M)
    check(len(h3d) == 3 and all(math.isfinite(float(v)) for v in h3d),
          f"hand3d 2d scores {h3d}")
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
    print(f"ratio driver (0.5, 1.0) with --with_hand3d: 10 stages exited 0 "
          f"in {seconds:.3f} s (each stage its own process); hand3d posenet "
          f"final loss {h3d_loss[0]} on the {n_aug} generated images, its 2d "
          f"EPE mean/median (px) and AUC {h3d}; GAN steps {gan}; HPE "
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
    6.  Returns the kernels' launches in the pix2pixhd run."""
    import numpy as np

    from mmhand_torch.data.annotations import load_annotations
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
        "gaussian_heatmaps": 0, **bn_launches(0, 0), **pad_launches(0, 0),
        "generate_jointsmap": -(-n // batch)},
        f"pix2pixhd: {got} labels, launches {p2p_launches}")
    print(f"export pix2pixhd: {n} labels and images in {seconds:.3f} s, "
          f"{n / seconds:.2f} images/s (PNG writes on the host), launches "
          f"{p2p_launches}")

    got, out, seconds, launches = _run_main(
        generate_pose_maps.main,
        [str(tmp / "keypoints.csv"), str(tmp / "pose" / "trainP"), "--size",
         str(size), str(size), "--sigma", str(CSV_TRAIN["sigma"])])
    first = np.load(tmp / "pose" / "trainP" / "color" / f"{min(annos)}.npy")
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
                       **bn_launches(BN_PER_STEP * steps,
                                     BN_PER_STEP * steps),
                       **pad_launches(PAD_PER_STEP[0] * steps,
                                      PAD_PER_STEP[1] * steps),
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
    weights, K1 twice per batch (P1, P2) and no other kernel.  Returns the
    kernels' launches in the run."""
    import warnings

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
    check(launches == {"gaussian_heatmaps": 2 * batches, **bn_launches(0, 0),
                       **pad_launches(PATN2_PAD_SITES * batches, 0),
                       "generate_jointsmap": 0},
          f"PATN2 launches {launches}")

    cfg = Config(model=ModelConfig(fine_size=size),
                 data=DataConfig(dataset="RHD", dataroot=str(test_crops)),
                 is_train=False)
    raw = next(HostLoader(build_dataset(cfg), batch, shuffle=False,
                          num_threads=1).epoch(0))
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
          f"peak device memory {peak_gib:.2f} GiB, launches {launches}")
    return launches


def pose_resnet_phase() -> dict:
    """PoseResNet-50 at batch 32 and 256 px in bf16: an eval forward, one
    train-mode forward and backward counting K2/K2b at its 56 BatchNorms;
    K2 over those 56 inputs against torch.batch_norm_stats.  Returns the
    kernels' launches in the train-mode pass."""
    import torch

    from benchmark import roofline
    from mmhand_torch.ops.bn_stats import bn_sums, bn_sums_ref

    size, batch, sites = FULL["size"], POSE["batch"], POSE["bn_sites"]
    net, x, gen = pose_resnet_batch()
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
    reset_launches()
    train_pass()
    torch.cuda.synchronize()
    launches = kernel_launches()
    check(launches == {"gaussian_heatmaps": 0, **bn_launches(sites, sites),
                       **pad_launches(0, 0), "generate_jointsmap": 0},
          f"PoseResNet train launches {launches}")
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in net.parameters()), "PoseResNet gradients")
    train_ms = cuda_ms(train_pass, iters=5, warmup=1)

    inputs = pose_resnet_bn_inputs(net, x)
    k2_ms = cuda_ms(lambda: [bn_sums(t) for t in inputs], iters=5)
    lib_ms = cuda_ms(lambda: [torch.batch_norm_stats(t, 1e-5) for t in inputs],
                     iters=5)
    plain_ms = cuda_ms(lambda: [bn_sums_ref(t) for t in inputs], iters=5)
    k2_device = kernel_device_ms(lambda: [bn_sums(t) for t in inputs],
                                 K2_KERNELS, calls=5)
    lib_device = kernel_device_ms(
        lambda: [torch.batch_norm_stats(t, 1e-5) for t in inputs],
        ("batch_norm",), calls=5)
    k2_bound = sum(roofline.k2_bound_s(t.numel(), t.element_size(),
                                       t.shape[1]) for t in inputs) * 1e3
    gb = sum(t.numel() * t.element_size() for t in inputs) / 1e9
    print(profile_step(train_pass, "PoseResNet-50 train pass",
                       {"K2": K2_KERNELS, "K2b": K2B_KERNELS}))
    print(f"PoseResNet-50 at batch {batch}, {size} px, bf16: eval forward "
          f"{eval_ms:.3f} ms, train-mode forward and backward {train_ms:.3f} "
          f"ms (CUDA events, median of 5); launches {launches}")
    print(f"PoseResNet-50 BatchNorm moments over its {sites} train-mode "
          f"inputs ({gb:.3f} GB, bf16): K2 {k2_ms:.4f} ms by CUDA events "
          f"({k2_device:.4f} ms of device time), torch.batch_norm_stats "
          f"{lib_ms:.4f} ms ({lib_device:.4f} ms), plain {plain_ms:.4f} ms, "
          f"bound {k2_bound:.4f} ms")
    return launches


def zoo_nets_phase() -> dict:
    """NLayerDiscriminator, PixelDiscriminator and PATN2Stream at full
    width: train-mode forwards and backwards at batch 8, 256 px, bf16,
    counting K2/K2b.  Then every init type on the flagship generator, each
    conv weight's std against its formula and the orthogonal ones
    semi-orthogonal.  Returns the kernels' launches in the train passes."""
    import torch

    from mmhand_torch.models.baselines import (
        NLayerDiscriminator,
        PATN2Stream,
        PixelDiscriminator,
    )
    from mmhand_torch.models.generator import Generator
    from mmhand_torch.models.layers import INIT_TYPES, init_weights, weight_fans

    size = FULL["size"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # each net and its train-mode BatchNorms
    nets = {"NLayerDiscriminator": (NLayerDiscriminator, 3),
            "PixelDiscriminator": (PixelDiscriminator, 1),
            "PATN2Stream": (PATN2Stream, 35)}
    total = {k: 0 for k in kernel_launches()}
    for name, (cls, bns) in nets.items():
        card = init_weights(cls(compute_dtype=None), "normal",
                            torch.Generator().manual_seed(SEED))
        card = card.to(device="cuda", memory_format=torch.channels_last)
        card.compute_dtype = torch.bfloat16
        card.train()
        x = torch.rand(8, size, size, 3, generator=gen, device="cuda") * 2 - 1
        if cls is PATN2Stream:
            x = (x, torch.rand(8, size, size, 42, generator=gen,
                               device="cuda"))
        reset_launches()
        out = card(x)
        out.float().square().mean().backward()
        torch.cuda.synchronize()
        launches = kernel_launches()
        # PATN2's stems pad inputs that need no gradient
        pads = ((PATN2_PAD_SITES, PATN2_PAD_SITES - 2) if cls is PATN2Stream
                else (0, 0))
        check(bool(torch.isfinite(out).all())
              and launches["bn_sums"] == launches["bn_sums_backward"] == bns
              and {k: launches[k] for k in pad_launches(0, 0)}
              == pad_launches(*pads),
              f"{name}: train pass, launches {launches}")
        print(f"{name}: train-mode pass at batch 8, {size} px, bf16: output "
              f"{tuple(out.shape)}, launches {launches}")
        for k, v in launches.items():
            total[k] += v
        del card, out

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


# ------------------------------------------------------------------ hand3d

def hand3d_train_phase(tmp: Path) -> dict:
    """train_hand3d.main for handsegnet, posenet and lifting (proposed) at
    256 px, batch 8, 6 steps each on synthetic records, then posenet
    resumed for 2 more: finite losses, every parameter tensor moved.
    Returns the kernels' launches (none: the hand3d nets hold no
    BatchNorm)."""
    import torch

    from mmhand_torch.hand3d import Hand3DSystem
    from mmhand_torch.scripts import train_hand3d

    size, batch, steps = HAND3D["size"], HAND3D["batch"], HAND3D["steps"]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    print(f"hand3d train: float32 (mmhand_tpu's dtype); TF32 in cuDNN "
          f"convolutions {'on' if tf32[0] else 'off'}, in matmuls "
          f"{'on' if tf32[1] else 'off'} (torch's defaults)")
    ckpt = tmp / "hand3d_ckpt"
    common = ["--image_size", str(size), "--crop_size", str(HAND3D["crop"]),
              "--batch_size", str(batch), "--checkpoints_dir", str(ckpt),
              "--name", "h3d", "--device", "cuda"]
    total: dict[str, int] = {}
    runs = [("handsegnet", ["--net", "handsegnet"], steps),
            ("posenet", ["--net", "posenet"], steps),
            ("lifting", ["--net", "lifting", "--variant", "proposed"], steps),
            ("posenet", ["--net", "posenet", "--continue_train"], steps + 2)]
    for name, argv, until in runs:
        resumed = "--continue_train" in argv
        result, out, _, launches = _run_main(
            train_hand3d.main, argv + common + ["--max_iter", str(until)])
        losses = result.losses
        check(len(losses) == (2 if resumed else steps)
              and all(math.isfinite(v) for v in losses),
              f"train_hand3d {name}: losses {losses}")
        check(result.system.step == until, f"{name}: step {result.system.step}")
        check(not any(launches.values()), f"{name}: launches {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if resumed:
            check("resumed at step 6" in out, f"{name} did not resume:\n{out}")
            print(f"train_hand3d --net posenet --continue_train: steps 7-8, "
                  f"losses {[round(v, 6) for v in losses]}")
            continue
        initial = Hand3DSystem(name, "proposed", HAND3D["crop"], "cpu",
                               seed=0).module.state_dict()
        still = [k for k, v in result.system.module.state_dict().items()
                 if torch.equal(v.cpu(), initial[k])]
        check(not still, f"{name}: {len(still)} tensors did not move: "
              f"{still[:6]}")
        n_params = sum(p.numel() for p in result.system.module.parameters())
        print(f"train_hand3d --net {name}: {steps} steps, losses "
              f"{[round(v, 6) for v in losses]}; every one of its "
              f"{len(initial)} tensors ({n_params} parameters) moved")
    return total


def hand3d_eval_phase(tmp: Path, crops: Path) -> dict:
    """(c) create_hand3d_db over the 160 RHD training crops, eval_hand3d in
    the three modes over that DB (posenet and lifting from the train phase,
    the full pipeline random), and the full pipeline's ms per batch of 8
    with single_obj_scoremap's share.  Returns the kernels' launches."""
    import numpy as np
    import torch

    from mmhand_torch.eval.evaluator import full_fp32
    from mmhand_torch.hand3d import load_color_hand_pose
    from mmhand_torch.ops.hand3d_image import single_obj_scoremap
    from mmhand_torch.scripts import create_hand3d_db, eval_hand3d

    size, batch = HAND3D["size"], HAND3D["batch"]
    db = tmp / "hand3d_gan.bin"
    n, out, seconds, launches = _run_main(
        create_hand3d_db.main, ["--dataroot", str(crops), "--out", str(db)])
    check(n == 160 and db.stat().st_size == n * (
        (42 * 5 + 9) * 4 + 2 + size * size * 4 + 42), f"GAN DB: {out}")
    print(f"create_hand3d_db: {n} records from the RHD training crops in "
          f"{seconds:.3f} s, {n / seconds:.2f} records/s (host clock)")
    total = dict(launches)
    for mode in ("2d", "3d", "full"):
        scores, out, seconds, launches = _run_main(eval_hand3d.main, [
            "--mode", mode, "--bin", str(db), "--name", "h3d",
            "--checkpoints_dir", str(tmp / "hand3d_ckpt"), "--image_size",
            str(size), "--crop_size", str(HAND3D["crop"]), "--batch_size",
            str(batch), "--device", "cuda"])
        check(all(math.isfinite(v) for v in scores.values())
              and 0.0 <= scores["auc"] <= 1.0 and not any(launches.values()),
              f"eval_hand3d --mode {mode}: {scores}, {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        print(f"eval_hand3d --mode {mode} over {n} records: {scores} in "
              f"{seconds:.3f} s, {n / seconds:.2f} images/s (random or "
              f"6-step weights: structural only)")

    net, _ = load_color_hand_pose(None, "h3d", HAND3D["crop"], "cuda")
    rng = np.random.RandomState(SEED)
    image = torch.from_numpy(rng.uniform(-0.5, 0.5, (batch, size, size, 3))
                             .astype(np.float32)).cuda()
    side = torch.tensor([[1.0, 0.0]], device="cuda").expand(batch, 2)
    with full_fp32():
        logits = net.detection(image)
        full_ms = cuda_ms(lambda: net(image, side), iters=10, warmup=2)
        mask_ms = cuda_ms(lambda: single_obj_scoremap(logits), iters=10,
                          warmup=2)
        mask_device_ms = kernel_device_ms(
            lambda: single_obj_scoremap(logits), ("max_pool", "pool2d"),
            calls=5)
    print(f"ColorHandPose3D at {size} px, batch {batch}, f32 TF32 off: "
          f"{full_ms:.3f} ms per batch, {batch / full_ms * 1e3:.2f} images/s; "
          f"single_obj_scoremap ({size // 10} passes of a 21x1 and a 1x21 "
          f"max pool) "
          f"{mask_ms:.3f} ms, {mask_ms / full_ms:.1%} of it; its pools "
          f"{mask_device_ms:.3f} ms of device time (profiler)")
    return total


def hand3d_demo_phase(tmp: Path, crops: Path) -> dict:
    """(d) run_hand3d on two crops, and handpose_judge with both judges on
    one sample directory; returns the kernels' launches."""
    import json
    import shutil

    import numpy as np

    from mmhand_torch.scripts import handpose_judge, run_hand3d

    images = sorted((crops / "color").glob("*.png"))[:2]
    out_dir = tmp / "hand3d_demo"
    written, out, seconds, total = _run_main(run_hand3d.main, [
        *map(str, images), "--out_dir", str(out_dir), "--device", "cuda",
        "--checkpoints_dir", str(tmp / "hand3d_ckpt")])
    for stem in written:
        coords = json.loads((out_dir / f"{stem}_coord3d.json").read_text())
        check(np.isfinite(coords["keypoint_coord3d"]).all()
              and np.asarray(coords["keypoint_coord3d"]).shape == (21, 3)
              and (out_dir / f"{stem}_crop_kp.png").stat().st_size > 0,
              f"run_hand3d {stem}: {coords}")
    check(len(written) == 2, f"run_hand3d wrote {written}")
    print(f"run_hand3d: {len(written)} overlays and coord3d JSONs in "
          f"{seconds:.3f} s")
    sample = tmp / "judge_sample"
    sample.mkdir()
    for i, path in enumerate(images):
        shutil.copy(path, sample / f"{i}.png")
    for judge in ("hand3d", "cpm"):
        lm, out, seconds, launches = _run_main(handpose_judge.main, [
            str(sample), "--judge", judge, "--device", "cuda",
            "--checkpoints_dir", str(tmp / "hand3d_ckpt")])
        for fname in ("gt_js.json", "pred_js.json"):
            marks = np.asarray(json.loads((sample / fname).read_text())[0][
                "landmarks"])
            check(marks.shape == (21, 3) and np.isfinite(marks).all(),
                  f"handpose_judge --judge {judge} {fname}: {marks.shape}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        print(f"handpose_judge --judge {judge}: gt_js.json and pred_js.json "
              f"of 21 finite landmarks in {seconds:.3f} s (random weights)")
    return total


# ------------------------------------------------------------ MSRA and V2V

def _msra_nets(gen):
    """The four nets at their fixed widths, lecun-normal weights from
    ``gen`` (mmhand_tpu's flax init)."""
    from mmhand_torch.models import voxel_nets
    from mmhand_torch.models.layers import init_lecun_normal

    return {name: init_lecun_normal(getattr(voxel_nets, name)(), gen)
            for name in MSRA_BN_SITES}


def _layout(name: str):
    import torch

    return (torch.channels_last_3d if name.startswith("Voxel")
            else torch.channels_last)


def msra_v2v_phase(tmp: Path) -> dict:
    """The MSRA/V2V group: an MSRA-layout tree read by MSRAHandDataset and
    voxel_sample; V2VVoxelization on the card; one train-mode step of each
    of the four nets at full width (K2 and K2b once per BatchNorm, 43 in
    all); K2b timed at the C=1 and C=21 sites and the largest 5-D one; a
    profiled VoxelGenerator step; the pose search over 76,375 poses on the
    card and on the CPU.  Returns the kernels' launches in the train
    steps."""
    import numpy as np
    import torch

    from benchmark import roofline
    from mmhand_torch.data.msra import MSRAHandDataset, voxel_sample
    from mmhand_torch.data.raw_sources import write_raw_msra
    from mmhand_torch.eval.pose_search import knn_pose_distance
    from mmhand_torch.models.layers import BatchNorm2d, BatchNorm3d
    from mmhand_torch.ops.bn_stats import (
        bn_sums_backward,
        bn_sums_backward_ref,
        bn_sums_ref,
    )
    from mmhand_torch.ops.voxelize import V2VVoxelization

    # 1. the data
    start = time.perf_counter()
    write_raw_msra(tmp / "msra", MSRA["frames"], seed=SEED)
    dataset = MSRAHandDataset(str(tmp / "msra"))
    check(len(dataset) == MSRA["frames"], f"{len(dataset)} MSRA frames")
    items = [dataset[i] for i in range(MSRA["samples"])]
    samples = [voxel_sample(item) for item in items]
    points = [int((s["points"][:, 2] < 1e9).sum()) for s in samples]
    check(all(0 < n < 32768 for n in points), f"hand points {points}")
    print(f"MSRA: {len(dataset)} frames of 320x240 read, {len(samples)} "
          f"voxel samples of {min(points)}-{max(points)} hand points "
          f"(padded to 32768) in {time.perf_counter() - start:.3f} s")

    # 2. V2VVoxelization (64^3, augmentation) on the card
    on_card = V2VVoxelization(MSRA["cubic"], True,
                              np.random.RandomState(SEED), "cuda")
    got = [on_card(sample) for sample in samples]
    inputs = torch.cat([g[0] for g in got])[..., None]    # (8, 64, 64, 64, 1)
    hands = torch.cat([g[2] for g in got])[..., None]
    check(float(inputs.sum()) > 0 and float(hands.sum()) > 0
          and all(bool(torch.isfinite(g[1]).all()) for g in got),
          "V2V: an empty cube or a non-finite keypoint coordinate")
    v2v_ms = cuda_ms(lambda: on_card(samples[0]), iters=10, warmup=2)
    print(f"V2VVoxelization at 64^3 with augmentation on the card: one "
          f"sample {v2v_ms:.3f} ms (CUDA events)")
    gen = torch.Generator().manual_seed(SEED)

    # 3. one full-width train step of each net (f32, cuDNN defaults)
    depth_uv = np.concatenate([np.stack([it["uv"] for it in items])] * 4)
    full = {
        "VoxelGenerator": inputs,
        "VoxelDiscriminator": torch.cat([inputs, hands], dim=-1),
        "DepthGenerator": torch.from_numpy(
            (depth_uv.reshape(len(depth_uv), 42) / 160.0 - 1.0).astype(
                np.float32))[:MSRA["depth_g_batch"]].cuda(),
        "DepthDiscriminator": torch.rand(
            MSRA["depth_d_batch"], 256, 256, 1, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(SEED)) * 2 - 1,
    }
    total = {k: 0 for k in kernel_launches()}
    sites = {}
    for name, net in _msra_nets(gen).items():
        net = net.to(device="cuda", memory_format=_layout(name)).train()
        opt = torch.optim.Adam(net.parameters(), lr=2e-4, betas=(0.5, 0.999))
        x = full[name]
        target = hands * 2 - 1 if name == "VoxelGenerator" else None

        def step():
            opt.zero_grad(set_to_none=True)
            out = net(x)
            outs = out if isinstance(out, tuple) else (out,)
            loss = ((out - target).abs().mean() if target is not None
                    else sum(o.float().square().mean() for o in outs))
            loss.backward()
            opt.step()
            return loss

        before = {k: v.detach().clone() for k, v in net.state_dict().items()}
        bn_inputs = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: bn_inputs.append(args[0].detach()))
            for m in net.modules() if isinstance(m, (BatchNorm2d, BatchNorm3d))]
        reset_launches()
        loss_value = float(step())
        torch.cuda.synchronize()
        launches = kernel_launches()
        for h in hooks:
            h.remove()
        n_bn = MSRA_BN_SITES[name]
        check(math.isfinite(loss_value), f"{name}: loss {loss_value}")
        check(launches == {"gaussian_heatmaps": 0, **bn_launches(n_bn, n_bn),
                           **pad_launches(0, 0), "generate_jointsmap": 0}
              and len(bn_inputs) == n_bn,
              f"{name}: launches {launches}, {len(bn_inputs)} inputs")
        still = [k for k, v in net.state_dict().items()
                 if not k.endswith("num_batches_tracked")
                 and torch.equal(v, before[k])]
        check(not still, f"{name}: {len(still)} tensors did not move: "
              f"{still[:4]}")
        for k, v in launches.items():
            total[k] += v
        step_ms = cuda_ms(step, iters=5, warmup=1)
        n_params = sum(p.numel() for p in net.parameters())
        print(f"{name} ({n_params} parameters) one train step at "
              f"{tuple(x.shape)}, f32: loss {loss_value:.6f}, every tensor "
              f"moved, launches {launches}; {step_ms:.3f} ms (CUDA events, "
              f"median of 5)")
        for t in bn_inputs:
            if t.shape[1] in (1, 21) or (t.dim() == 5 and t.numel() > max(
                    (u.numel() for u in sites.values() if u.dim() == 5),
                    default=0)):
                sites.setdefault(f"{name} {tuple(t.shape)}", t)
        del net, opt, bn_inputs
    check(total["bn_sums"] == total["bn_sums_backward"]
          == sum(MSRA_BN_SITES.values()),
          f"MSRA/V2V train launches {total}")

    # 4. K2b at the C=1 and C=21 sites and the largest 5-D one, and both
    # plain versions (K2's times there: bn_site_phase)
    largest = max((t.numel() for t in sites.values() if t.dim() == 5))
    for where, t in sites.items():
        if t.shape[1] not in (1, 21) and t.numel() != largest:
            continue
        c = t.shape[1]
        g1 = torch.randn(c, device="cuda")
        g2 = torch.randn(c, device="cuda")
        k2b = kernel_device_ms(lambda: bn_sums_backward(t, g1, g2),
                               K2B_KERNELS)
        plain = cuda_ms(lambda: bn_sums_ref(t), iters=10)
        plain_b = cuda_ms(lambda: bn_sums_backward_ref(t, g1, g2), iters=10)
        nbytes = t.numel() * t.element_size()
        k2b_bound = roofline.k2b_bound_s(t.numel(), t.element_size(), c) * 1e3
        print(f"K2b at {where} {t.dtype} ({nbytes / 1e6:.1f} MB): "
              f"{k2b:.4f} ms of device time (profiler), bound "
              f"{k2b_bound:.4f} ms ({100 * k2b_bound / k2b:.1f}%); plain "
              f"K2 / K2b {plain:.4f} / {plain_b:.4f} ms (CUDA events)")
    vg = _msra_nets(gen)["VoxelGenerator"].to(
        device="cuda", memory_format=torch.channels_last_3d).train()
    vg_opt = torch.optim.Adam(vg.parameters(), lr=2e-4, betas=(0.5, 0.999))

    def vg_step():
        vg_opt.zero_grad(set_to_none=True)
        (vg(inputs) - (hands * 2 - 1)).abs().mean().backward()
        vg_opt.step()

    print(profile_step(vg_step, f"one VoxelGenerator train step at "
                       f"{tuple(inputs.shape)}",
                       {"K2": K2_KERNELS, "K2b": K2B_KERNELS}))
    del vg, vg_opt

    # 5. the pose search
    prng = np.random.RandomState(SEED)
    database = prng.normal(0, 40, (MSRA["poses"], 21, 3))
    query = prng.normal(0, 40, (21, 3))
    idx, dist = knn_pose_distance(query, database, MSRA["k"], device="cuda")
    check(len(idx) == MSRA["k"] and bool(np.isfinite(dist).all()),
          f"pose search: {len(idx)} neighbours, distances {dist[:5]}")
    calls = 10
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        knn_pose_distance(query, database, MSRA["k"], device="cuda")
    per_query = (time.perf_counter() - start) / calls * 1e3
    start = time.perf_counter()
    knn_pose_distance(query, database, MSRA["k"], device="cpu")
    cpu_ms = (time.perf_counter() - start) * 1e3
    print(f"knn_pose_distance, k {MSRA['k']} over {MSRA['poses']} poses "
          f"(float64): {per_query:.3f} ms per query on the card (host clock, "
          f"the numpy bone vectors and the copy in), {cpu_ms:.3f} ms on the "
          f"CPU")
    return total


PHASE_SECONDS: dict[str, float] = {}


def timed(phase, *args):
    """``phase(*args)``, its seconds on the host clock kept under its
    name."""
    start = time.perf_counter()
    out = phase(*args)
    PHASE_SECONDS[phase.__name__] = time.perf_counter() - start
    return out


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

    k1 = timed(kernel_phase)
    k2, k2b = timed(bn_kernel_phase)
    timed(bn_site_phase)
    bn_apply_rec, bn_apply_bwd_rec = timed(bn_apply_phase)
    pad_rec, pad_bwd_rec = timed(reflect_pad_phase)
    k3 = timed(jointsmap_kernel_phase)
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        paths["generation"] = timed(slice_phase, tmp)
        paths["train"] = timed(train_slice_phase, tmp)
        paths["fp16 train"] = timed(fp16_train_phase, tmp)
        paths["resume"] = timed(resume_phase, tmp)
        paths["NCCL world 1"] = timed(nccl_phase, tmp)
        paths["gloo 2 ranks (rank 0)"] = timed(gloo_phase, tmp)
        paths["longrun (leg 2 and SSIM)"] = timed(longrun_phase, tmp)
        paths["evaluation"] = timed(eval_slice_phase, tmp)
        paths["HPE train"], tree = timed(hpe_train_phase, tmp)
        paths["HPE test"] = timed(hpe_test_phase, tmp, tree)
        timed(ratio_driver_phase, tmp, tree)
        crops, test_crops, paths["preprocessing"] = timed(preprocess_phase, tmp)
        paths["pix2pixhd export"] = timed(export_phase, tmp, crops)
        paths["CSV train"] = timed(csv_train_phase, tmp)
        paths["PATN2 scoring"] = timed(patn2_phase, test_crops)
        paths["PoseResNet-50 train"] = timed(pose_resnet_phase)
        paths["zoo nets train"] = timed(zoo_nets_phase)
        paths["hand3d train"] = timed(hand3d_train_phase, tmp)
        paths["hand3d DB and evaluation"] = timed(hand3d_eval_phase, tmp, crops)
        paths["hand3d demos"] = timed(hand3d_demo_phase, tmp, crops)
        paths["MSRA/V2V train"] = timed(msra_v2v_phase, tmp)
    # K1 runs on every path that renders heatmaps, K2 and K2b on the train
    # paths, K3 on the baselines' evaluation path and the pix2pixhd export,
    # the pad on the GAN's and the baselines' paths
    for rec, name in ((k1, "gaussian_heatmaps"), (k2, "bn_sums"),
                      (k2b, "bn_sums_backward"), (pad_rec, "reflect_pad"),
                      (pad_bwd_rec, "reflect_pad_backward"),
                      (k3, "generate_jointsmap")):
        rec["launches"] = sum(p.get(name, 0) for p in paths.values())
        check(rec["launches"] > 0, f"{name} was launched on no path")
    # the normalize's kernels run once beside each K2 and K2b launch
    for rec, name in ((bn_apply_rec, "bn_apply"),
                      (bn_apply_bwd_rec, "bn_apply_backward")):
        rec["launches"] = sum(p.get(name, 0) for p in paths.values())
    check(all(p.get("bn_apply", 0) == p.get("bn_sums", 0)
              and p.get("bn_apply_backward", 0)
              == p.get("bn_sums_backward", 0) for p in paths.values()),
          "the normalize's launches differ from K2's or K2b's on a path")
    check(all(paths[p]["bn_sums"] > 0 and paths[p]["bn_sums_backward"] > 0
              for p in paths if p not in ("generation", "evaluation",
                                          "HPE train", "HPE test",
                                          "preprocessing", "pix2pixhd export",
                                          "PATN2 scoring", "hand3d train",
                                          "hand3d DB and evaluation",
                                          "hand3d demos")),
          "K2 or K2b was not launched on a train path")
    check(all(paths[p].get("reflect_pad", 0)
              == paths[p].get("reflect_pad_backward", 0) == 0
              for p in ("HPE train", "HPE test", "preprocessing",
                        "pix2pixhd export", "PoseResNet-50 train",
                        "hand3d train", "hand3d DB and evaluation",
                        "hand3d demos", "MSRA/V2V train")),
          "the reflect pad was launched on a path with no reflect padding")
    print("launches by path: " + "; ".join(
        f"{p} {dict((k, v) for k, v in l.items() if v)}"
        for p, l in paths.items()))

    print("phase seconds (host clock): " + json.dumps(
        {k: round(v, 3) for k, v in PHASE_SECONDS.items()}))

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
             "skipped_share"]
    print(json.dumps({"kernels": [{k: rec[k] for k in order}
                                  for rec in (k1, k2, k2b, bn_apply_rec,
                                              bn_apply_bwd_rec, pad_rec,
                                              pad_bwd_rec, k3)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
