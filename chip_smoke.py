#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mmhand_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from mmhand_torch/csrc/ with nvcc.
2. Holds each kernel against its plain PyTorch version on the card, at the
   generation path's shapes and at a ragged one, and times both.
3. Holds the port on the card against the port on the CPU (the path the
   tests hold against mmhand_tpu) on a small input: batch preparation and a
   toy generator in float32.
4. Drives the generation path at full width (ngf 64, 9 PATBlocks, 256x256,
   batch norm, bf16 autocast, gen_batch 16) through
   ``mmhand_torch.scripts.aug.main`` over the synthetic dataset, counting the
   kernel launches of that run, then checks the written PNGs against the
   generator's output and the bf16 output against float32.

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
        if not record:
            record = {"name": "gaussian_heatmaps", "route": "cuda",
                      "source": "mmhand_torch/csrc/heatmap.cu",
                      "replaces": K1_REPLACES, "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms}
    return record


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
    from mmhand_torch.utils.checkpoint import save_generator
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
    save_generator(g, str(tmp / "ckpt"), "smoke")
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
    small_reference_phase()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        k1["launches"] = slice_phase(Path(tmp))
    check(k1["launches"] > 0, "K1 was not launched on the main path")

    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms"]
    print(json.dumps({"kernels": [{k: k1[k] for k in order}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
