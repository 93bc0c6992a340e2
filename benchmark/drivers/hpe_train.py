"""The HPE train loop of ``mmhand_torch.scripts.train_hpe.train_hpe``, one
step at a time: each epoch's order (``epoch_permutation``), the batch read
by ``HPEMixDataset.batch`` on the loop's own thread, as ``train_hpe``
reads it, ``make_hpe_prepare_batch`` (K1 at sigma 5) and the step of
``make_hpe_train_step(HPESystem(cfg, variant))``; the losses are fetched to
the host every ``print_freq`` steps, the saves left out.

Set-up as in ``gan_train``: the system is built once, takes the
benchmark's weights, and its first ``checked_steps`` steps through the
window's own call record what the check compares; it then goes on into
the window.
"""

from __future__ import annotations

import torch

from benchmark import weights as bw
from benchmark.drivers import common
from benchmark.reference import compare
from benchmark.reference import hpe as ref
from benchmark.reference.gan import load_weights
from benchmark.reference.layers import exact_f32, fp8, set_quant
from benchmark.roofline import FlopCounter, k1_bound_s
from benchmark.traffic.tree import load_annotations

NETS = ("hpm2d", "hpm3d")


def hpe_specs(nets: dict) -> list:
    """flax's default: lecun_normal kernels, zero biases."""
    return common.weight_specs(nets, "trunc",
                               lambda m: common.fan_in(m) ** -0.5)


class Run:
    def __init__(self, cell, seed: int, spans, device="cuda"):
        from mmhand_torch.data.loader import epoch_permutation
        from mmhand_torch.hpe import (
            HPEMixDataset,
            HPESystem,
            make_hpe_prepare_batch,
            make_hpe_train_step,
        )
        from mmhand_torch.train.step import LRSchedule

        c, t = cell.config, cell.traffic
        self.cell, self.seed, self.spans = cell, seed, spans
        self.device = torch.device(device)
        self.root = common.tree_root(t["tree_items"], c["model"]["fine_size"])
        self.cfg = cfg = common.port_config(cell, seed, self.root)
        self.system = HPESystem(cfg, c["variant"], self.device)
        self.nets = {"hpm2d": self.system.hpm2d, "hpm3d": self.system.hpm3d}
        self.specs = hpe_specs(self.nets)
        drawn = bw.draw(self.specs, seed, self.device)
        for prefix, net in self.nets.items():
            bw.load_into(net, drawn, prefix + ".")
        del drawn
        self.step_fn = make_hpe_train_step(self.system)
        self.prepare = make_hpe_prepare_batch(t["sigma"], self.device)
        self.dataset = HPEMixDataset(cfg, is_train=True)
        self.permutation = epoch_permutation
        self.sched = LRSchedule(cfg)
        self.batch_size = c["batch_size"]
        self.epoch = cfg.optim.epoch_count - 1
        self.order, self.at = [], 0
        self.lr = cfg.optim.lr
        self.total = 0
        self.unit_per_step = self.batch_size
        self.trace_after = t["trace_after"]
        self.trace_steps = t["trace_steps"]
        self.print_freq = t["print_freq"]
        self.got = self._checked_steps(t["checked_steps"])
        flops = FlopCounter(self.nets.values())
        with flops.counting():
            self.step()
        self.flops_per_step = flops.flops
        for _ in range(t["warmup_steps"]):
            self.step()
        self.total = 0

    def _next_indices(self):
        if self.at + self.batch_size > len(self.order):
            self.epoch += 1
            self.lr = self.sched.epoch_lr(
                self.epoch - self.cfg.optim.epoch_count, None)
            self.order = self.permutation(len(self.dataset),
                                          self.cfg.data.seed, self.epoch)
            self.at = 0
        idx = self.order[self.at:self.at + self.batch_size]
        self.at += self.batch_size
        return idx

    def _one(self):
        with self.spans("loader"):
            idx = self._next_indices()
            raw = self.dataset.batch(idx)
        with self.spans("prepare"):
            batch = self.prepare(raw)
        with self.spans("step"):
            metrics = self.step_fn(batch, self.lr)
        self.total += 1
        return idx, raw, metrics

    def step(self) -> int:
        _, _, metrics = self._one()
        if self.total % self.print_freq == 0:
            with self.spans("fetch"):
                {k: float(v) for k, v in metrics.items()}
        return self.unit_per_step

    def _checked_steps(self, n: int) -> dict:
        losses, grads = [], {}
        self.paths, self.lrs = [], []
        for i in range(n):
            idx, raw, metrics = self._one()
            self.paths.append([self.dataset.paths[int(j)] for j in idx])
            self.lrs.append(self.lr)
            losses.append({k: float(metrics[k]) for k in ref.LOSS_KEYS})
            if i == 0:
                grads = common.first_grads(
                    [("hpm2d", self.system.hpm2d, self.system.opt2d),
                     ("hpm3d", self.system.hpm3d, self.system.opt3d)],
                    self.cfg.optim.beta1)
                size = self.cell.config["model"]["fine_size"]
                self.k1_s = k1_bound_s(torch.as_tensor(raw["uv"]), size, size,
                                       self.cell.traffic["sigma"])
        change = common.change_norms(
            self.nets, bw.draw(self.specs, self.seed, self.device))
        return {"losses": losses, "grad_norms": grads,
                "change_norms": change}

    def release(self) -> None:
        for name in ("system", "step_fn", "nets", "dataset", "prepare"):
            setattr(self, name, None)
        common.free_cuda()

    def reference(self, quant=None, rows=None) -> dict:
        c = self.cell.config
        annos = load_annotations(self.root)
        with exact_f32():
            nets = ref.build_nets(c["num_joints"], c["model"]["fine_size"],
                                  self.device)
            load_weights(nets, bw.draw(self.specs, self.seed, self.device))
            for net in nets.values():
                set_quant(net, quant)
            batches = []
            for paths in self.paths:
                b = ref.hpe_batch(self.root, annos, paths,
                                  self.cell.traffic["sigma"], self.device)
                batches.append({k: v[:rows] for k, v in b.items()})
            hp = {"beta1": self.cfg.optim.beta1,
                  "beta2": self.cfg.optim.beta2,
                  "stage_loss_scale": c["stage_loss_scale"]}
            out = ref.train_steps(nets, batches, self.lrs, hp)
        del nets
        common.free_cuda()
        return out

    def check(self) -> dict:
        numbers = compare.train_gaps(self.got, self.reference())
        return compare.with_limits(numbers, self.cell.limits)

    def control_readings(self) -> dict:
        """The check's numbers for the program, for the reference in
        float8 put in its place (the control), and for the faults a
        training cell can have, each against the float32 reference."""
        want = self.reference()
        rows = self.cell.config["batch_size"] // 2
        return compare.control_readings(self.got, want, {
            "fp8": self.reference(quant=fp8),
            "half_batch": self.reference(rows=rows)})
