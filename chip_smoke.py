#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mmhand_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from mmhand_torch/csrc/ with nvcc.
2. Holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at a ragged one, and times it beside its plain
   version, its bound and, where one exists, the one PyTorch call that
   computes the same function: K1 (heatmaps), K2 (BatchNorm sums) and K2b
   (their backward).
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
   from the saved generator; times one step's phases and profiles one step.

Prints the kernels' JSON line, then the card's name and power limit, then
``{"ok": true, "device": {...}}`` as the last line.  Any failed phase raises
and the exit code is not 0; without a CUDA device, or without the package
beside this file, it stops before printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
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
BN_SOURCE = "mmhand_torch/csrc/bn_stats.cu"
# the largest BatchNorm input of the train step, a PATBlock attention
# stream's, and a ragged shape in f32
BN_SHAPES = [((16, 64, 256, 256), "bfloat16"), ((16, 512, 64, 64), "bfloat16"),
             ((3, 29, 37, 41), "float32")]
# the train slice: the JAX Config() flagship (ngf 64, 9 PATBlocks, 256 px),
# batch 16, a few steps; its BatchNorms: 47 in G, 9 in each D, run once in
# G, twice in the G loss's D forwards and twice in each D phase
TRAIN = dict(steps=6, batch=16)
BN_PER_STEP = 47 + 2 * 9 + 2 * 9 + 2 * 9
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
F32_FLOPS = 67e12           # H100 SXM, outside the tensor cores


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


def kernel_phase():
    """K1 against gaussian_heatmaps_ref on the card; returns its record."""
    import torch

    from mmhand_torch.ops.heatmap import gaussian_heatmaps, gaussian_heatmaps_ref

    rng = torch.Generator().manual_seed(SEED)
    record = {}
    for batch, height, width in [(FULL["gen_batch"], FULL["size"], FULL["size"]),
                                 (3, 70, 90)]:
        scale = torch.tensor([width, height], dtype=torch.float32)
        uv = (torch.rand(batch, 21, 2, generator=rng) * 1.2 - 0.1) * scale
        uv = uv.cuda()
        got = gaussian_heatmaps(uv, height, width, 6.0)
        torch.cuda.synchronize()
        want = gaussian_heatmaps_ref(uv, height, width, 6.0)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (batch, height, width, 21),
              f"heatmap shape {tuple(got.shape)}")
        err, exempt = heatmap_error(got, want, uv, height, width, 6.0)
        # the plain version on CUDA divides by 2 sigma^2 as a multiply by
        # its reciprocal, K1 divides: a last-bit difference before exp
        check(err <= 1e-6, f"K1 differs from the plain version by {err}")
        ms = cuda_ms(lambda: gaussian_heatmaps(uv, height, width, 6.0))
        plain_ms = cuda_ms(lambda: gaussian_heatmaps_ref(uv, height, width, 6.0))
        print(f"K1 gaussian_heatmaps ({batch}, {height}, {width}, 21): "
              f"max_abs_err {err} ({exempt} clip-boundary pixels exempt); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per call")
        # f32 writes of the output, ~8 f32 operations and one exp per pixel
        k1_bound, k1_by = bound(got.numel() * 4 + uv.numel() * 4,
                                9 * got.numel())
        print(f"K1 bound {k1_bound:.4f} ms ({k1_by}); no single PyTorch call "
              f"computes the same function")
        if not record:
            record = {"name": "gaussian_heatmaps", "route": "cuda",
                      "source": "mmhand_torch/csrc/heatmap.cu",
                      "replaces": K1_REPLACES, "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": k1_bound,
                      "bound_by": k1_by, "library_ms": None}
    return record


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least milliseconds for the work on an H100 SXM at 700 W: bytes over
    3.35 TB/s of HBM, f32 operations over 67 TFLOP/s, whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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
        s1, s2 = bn_sums(x)
        torch.cuda.synchronize()
        r1, r2 = bn_sums_ref(x)
        # f32 sums taken in another order: the error is held relative to
        # sum |x| and sum x^2, which bound the rounding of any order
        scale1 = x.float().abs().sum((0, 2, 3))
        rel1 = float(((s1 - r1).abs() / scale1).max())
        rel2 = float(((s2 - r2).abs() / r2).max())
        check(rel1 <= 1e-5 and rel2 <= 1e-5,
              f"K2 at {shape} {dtype}: relative errors {rel1}, {rel2}")
        err = max(float((s1 - r1).abs().max()), float((s2 - r2).abs().max()))

        g1 = torch.randn(c, generator=gen, device="cuda")
        g2 = torch.randn(c, generator=gen, device="cuda")
        dx = bn_sums_backward(x, g1, g2)
        torch.cuda.synchronize()
        check(dx.dtype == x.dtype and dx.shape == x.shape
              and dx.is_contiguous(memory_format=torch.channels_last),
              f"K2b output {dx.dtype} {tuple(dx.shape)}")
        # the plain formula in the same order, one rounding per operation
        bwd_err = float((dx.float() - bn_sums_backward_ref(x, g1, g2).float()
                         ).abs().max())
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
            records = [
                {"name": "bn_sums", "route": "cuda", "source": BN_SOURCE,
                 "replaces": K2_REPLACES, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": k2_bound,
                 "bound_by": k2_by, "library_ms": library_ms},
                {"name": "bn_sums_backward", "route": "cuda",
                 "source": BN_SOURCE, "replaces": K2B_REPLACES,
                 "max_abs_err": bwd_err, "ms": bwd_ms,
                 "plain_ms": bwd_plain_ms, "bound_ms": k2b_bound,
                 "bound_by": k2b_by, "library_ms": None}]
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


def profile_step(fn) -> str:
    """One call of ``fn`` under torch.profiler: the device time of K2's and
    K2b's kernels, of all kernels, and the device's busy share of the
    window.  The trace is untried on this machine, so a profiler that
    yields no device time is reported, not failed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    sums = {"K2": 0.0, "K2b": 0.0, "all": 0.0}
    kernels = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if ev.device_type != torch.autograd.DeviceType.CUDA or not us:
            continue
        kernels.append((us / 1e3, ev.count, ev.key))
        sums["all"] += us / 1e3
        if "bn_sums_backward_kernel" in ev.key:
            sums["K2b"] += us / 1e3
        elif "bn_sums_" in ev.key:
            sums["K2"] += us / 1e3
    if not sums["all"]:
        return "profiled step: no device time in the trace (not measured)"
    top = "\n".join(f"  {ms:9.3f} ms {n:5d}x {key[:90]}"
                    for ms, n, key in sorted(kernels, reverse=True)[:12])
    return (f"profiled step: K2 {sums['K2']:.3f} ms, K2b {sums['K2b']:.3f} ms, "
            f"all kernels {sums['all']:.3f} ms of {wall_ms:.3f} ms wall "
            f"(device busy {100 * sums['all'] / wall_ms:.1f}%); top kernels:\n"
            f"{top}")


def train_slice_phase(tmp: Path) -> dict:
    """The full-width train step through scripts.train.main, then its
    checkpoint through aug.main; returns the kernels' launches in the train
    run."""
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
    print(profile_step(lambda: step(batch, lr)))
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
    return launches


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
    small_reference_phase()
    small_train_phase()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        gen_k1 = slice_phase(Path(tmp))
        check(gen_k1 > 0, "K1 was not launched on the generation path")
        train = train_slice_phase(Path(tmp))
    # K1 runs on both paths, K2 and K2b on the train path
    k1["launches"] = gen_k1 + train["gaussian_heatmaps"]
    k2["launches"] = train["bn_sums"]
    k2b["launches"] = train["bn_sums_backward"]
    print(f"launches: K1 {gen_k1} in the generation slice, "
          f"{train['gaussian_heatmaps']} in the train slice; K2 "
          f"{k2['launches']}, K2b {k2b['launches']} in the train slice")

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: rec[k] for k in order}
                                  for rec in (k1, k2, k2b)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
