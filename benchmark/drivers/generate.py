"""The per-batch body of ``mmhand_torch.scripts.aug.generate``: the
``HostLoader`` (no shuffle) over the dataset's generate split,
``make_prepare_batch``, ``make_eval_step(G)``, ``denormalize_image``, the
fetch to the host and ``utils.png.write_png`` of every fake, under a
directory of the run's TMPDIR that is deleted at the end.

Set-up builds the generator (``build_generator``), loads the benchmark's
weights, and sets its BatchNorm running statistics from one train-mode
pass over the first batch, with momentum 1 and dropout off, as a trained
generator would carry them.  The check reads back a sample of the fakes
written in the window, drawn from the seed, and compares them with the
reference's, computed in float32 from the same files and weights.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import numpy as np
import torch

from benchmark import weights as bw
from benchmark.drivers import common
from benchmark.reference import gan as ref
from benchmark.reference.compare import with_limits
from benchmark.reference.layers import exact_f32, fp8, set_quant
from benchmark.roofline import FlopCounter, k1_bound_s
from benchmark.traffic.png import read_png
from benchmark.traffic.tree import load_annotations


class Run:
    def __init__(self, cell, seed: int, spans, device="cuda"):
        from mmhand_torch.data import (
            HostLoader,
            build_dataset,
            make_prepare_batch,
        )
        from mmhand_torch.ops.image import denormalize_image
        from mmhand_torch.train.state import build_generator
        from mmhand_torch.train.step import make_eval_step
        from mmhand_torch.utils.png import write_png

        c, t = cell.config, cell.traffic
        self.cell, self.seed, self.spans = cell, seed, spans
        self.device = torch.device(device)
        self.root = common.tree_root(t["tree_items"], c["model"]["fine_size"])
        self.cfg = cfg = common.port_config(cell, seed, self.root,
                                            is_train=False)
        self.generator = build_generator(cfg, self.device, seed=seed)
        self.specs = common.weight_specs({"generator": self.generator},
                                         "normal", lambda m: 0.02)
        bw.load_into(self.generator, bw.draw(self.specs, seed, self.device),
                     "generator.")
        self.eval_step = make_eval_step(self.generator)
        self.denormalize, self.write_png = denormalize_image, write_png
        self.loader = HostLoader(build_dataset(cfg), t["gen_batch"],
                                 seed=cfg.data.seed, shuffle=False,
                                 drop_last=False)
        self.prepare = make_prepare_batch(cfg.data.sigma, self.device)
        self.out_dir = tempfile.mkdtemp(prefix="mmhand_gen_")
        atexit.register(shutil.rmtree, self.out_dir, True)
        self.epoch, self.batches = -1, iter(())
        self.trace_after = t["trace_after"]
        self.trace_steps = t["trace_steps"]
        self.unit_per_step = t["gen_batch"]
        self.written = []                  # (src path, tgt path, out path)

        raw = self._next_raw()
        self.calibration = (list(raw["src_paths"]), list(raw["tgt_paths"]))
        self._calibrate(self._prepared(raw))
        self.k1_s = k1_bound_s(torch.as_tensor(raw["tgt_uv"]),
                               c["model"]["fine_size"],
                               c["model"]["fine_size"], cfg.data.sigma)
        flops = FlopCounter([self.generator])
        with flops.counting():
            self.step()
        self.flops_per_step = flops.flops
        for _ in range(t["warmup_batches"]):
            self.step()
        self.written = []

    def _prepared(self, raw):
        return self.prepare({k: v for k, v in raw.items()
                             if not k.endswith("paths")})

    def _calibrate(self, batch) -> None:
        g = self.generator
        bns = [m for m in g.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        g.train()
        for m in g.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()
        for m in bns:
            m.momentum = 1.0
        with torch.no_grad():
            g((batch["H1"], torch.cat([batch["P1"], batch["P2"]], -1),
               torch.cat([batch["D1"], batch["D2"]], -1)))
        for m in bns:
            m.momentum = 0.1
        g.eval()

    def _next_raw(self) -> dict:
        while True:
            raw = next(self.batches, None)
            if raw is not None:
                return raw
            self.epoch += 1
            self.batches = iter(self.loader.epoch(self.epoch))

    def step(self) -> int:
        with self.spans("loader"):
            raw = self._next_raw()
        with self.spans("prepare"):
            batch = self._prepared(raw)
        with self.spans("step"):
            fake = self.eval_step(batch)
        with self.spans("png_write"):
            fakes = self.denormalize(fake).cpu().numpy()
            for i, tgt in enumerate(raw["tgt_paths"]):
                folder = os.path.basename(os.path.dirname(tgt))
                out = os.path.join(self.out_dir, folder)
                os.makedirs(out, exist_ok=True)
                path = os.path.join(out, os.path.basename(tgt))
                self.write_png(path, fakes[i])
                self.written.append((raw["src_paths"][i], tgt, path))
        return len(raw["tgt_paths"])

    def release(self) -> None:
        if hasattr(self.batches, "close"):
            self.batches.close()
        for name in ("generator", "eval_step", "loader", "batches",
                     "prepare"):
            setattr(self, name, None)
        common.free_cuda()

    def sample(self) -> list:
        """The fakes the check reads: ``checked_images`` of those written
        in the window, drawn from the seed, the last write of each file."""
        last = {out: (src, tgt) for src, tgt, out in self.written}
        keys = sorted(last)
        n = min(self.cell.traffic["checked_images"], len(keys))
        pick = np.random.default_rng(self.seed).choice(len(keys), n,
                                                       replace=False)
        return [(last[keys[i]][0], last[keys[i]][1], keys[i])
                for i in sorted(pick)]

    def reference(self, items, quant=None) -> list:
        """The reference's uint8 fakes of ``items`` (src, tgt, _)."""
        c, t = self.cell.config, self.cell.traffic
        annos = load_annotations(self.root)
        sigma = self.cfg.data.sigma
        out = []
        with exact_f32():
            nets = ref.build_nets(c["model"], self.cfg.loss.perceptual_layers,
                                  self.device)
            g = set_quant(nets["generator"], quant)
            ref.load_weights({"generator": g},
                             bw.draw(self.specs, self.seed, self.device))
            ref.calibrate(g, ref.gan_batch(self.root, annos,
                                           *self.calibration, sigma,
                                           self.device))
            for i in range(0, len(items), t["gen_batch"]):
                chunk = items[i:i + t["gen_batch"]]
                b = ref.gan_batch(self.root, annos, [s for s, _, _ in chunk],
                                  [g_ for _, g_, _ in chunk], sigma,
                                  self.device)
                out.extend(ref.fakes_u8(g, b).cpu().numpy())
        del nets
        common.free_cuda()
        return out

    def _written_gap(self, items, want) -> float:
        """The mean gap, in 8-bit levels, between the sampled fakes as
        written and ``want``; a fake due in the window that is not there
        reads as infinitely far."""
        gaps = []
        for (_, _, path), w in zip(items, want):
            if not os.path.exists(path):
                return float("inf")
            got = read_png(path).astype(np.int16)
            gaps.append(float(np.abs(got - w.astype(np.int16)).mean()))
        return float(np.mean(gaps)) if gaps else float("inf")

    def check(self) -> dict:
        """``level_gap`` of the sampled fakes against the reference's."""
        try:
            items = self.sample()
            gap = self._written_gap(items, self.reference(items))
        finally:
            shutil.rmtree(self.out_dir, ignore_errors=True)
        return with_limits({"level_gap": gap}, self.cell.limits)

    def control_readings(self) -> dict:
        """``level_gap`` of the program and of the reference in float8 put
        in its place, each against the float32 reference."""
        try:
            items = self.sample()
            want = self.reference(items)
            control = self.reference(items, quant=fp8)
            program = self._written_gap(items, want)
        finally:
            shutil.rmtree(self.out_dir, ignore_errors=True)
        gap = float(np.mean([np.abs(c.astype(np.int16) - w.astype(np.int16)
                                    ).mean() for c, w in zip(control, want)]))
        return {"program": {"level_gap": program},
                "fp8": {"level_gap": gap}}
