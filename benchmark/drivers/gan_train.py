"""The GAN train loop of ``mmhand_torch.train.loop.train``, one step at a
time: ``HostLoader.epoch`` -> ``make_prepare_batch`` -> ``TrainStep``,
with the losses fetched to the host every ``print_freq`` steps.  The
Visualizer's snapshot and the checkpoint saves, every 5,000 steps, are left
out.

Set-up builds the system once (``build_system``), loads the benchmark's
weights into it, and drives it through its first ``checked_steps`` steps
by the window's own call and feed, recording what the correctness check
compares: each step's losses, each leaf's first gradient as Adam holds it,
each leaf's change over those steps, the batches' file names and the
dropout masks drawn.  Then it counts the step's model FLOPs and
BatchNorm sites and warms up; the same system goes on into the window.
"""

from __future__ import annotations

import warnings

import torch

from benchmark import weights as bw
from benchmark.drivers import common
from benchmark.reference import compare
from benchmark.reference import gan as ref
from benchmark.reference.layers import MaskSource, exact_f32, fp8, set_masks
from benchmark.roofline import BatchNormSites, FlopCounter, k1_bound_s
from benchmark.traffic.tree import load_annotations

NETS = ("generator", "d_pb", "d_pp")


def gan_specs(nets: dict) -> list:
    """G and the Ds: N(0, 0.02) kernels (MM-Hand's init_type normal); the
    VGG: N(0, 1 / fan_in) kernels."""
    specs = common.weight_specs({k: nets[k] for k in NETS}, "normal",
                                lambda m: 0.02)
    return specs + common.weight_specs(
        {"vgg": nets["vgg"]}, "normal", lambda m: common.fan_in(m) ** -0.5)


def hyper(cfg) -> dict:
    return {"lambda_a": cfg.loss.lambda_a, "lambda_b": cfg.loss.lambda_b,
            "lambda_gan": cfg.loss.lambda_gan, "beta1": cfg.optim.beta1,
            "beta2": cfg.optim.beta2, "pool_size": cfg.optim.pool_size}


class Run:
    def __init__(self, cell, seed: int, spans, device="cuda"):
        from mmhand_torch.data import make_prepare_batch
        from mmhand_torch.train.loop import make_loader
        from mmhand_torch.train.state import build_system
        from mmhand_torch.train.step import LRSchedule, make_train_step

        t = cell.traffic
        self.cell, self.seed, self.spans = cell, seed, spans
        self.device = torch.device(device)
        self.root = common.tree_root(t["tree_items"],
                                     cell.config["model"]["fine_size"])
        self.cfg = cfg = common.port_config(cell, seed, self.root)
        with warnings.catch_warnings():
            # its VGG's random weights: the benchmark loads its own
            warnings.simplefilter("ignore", UserWarning)
            s = self.system = build_system(cfg, self.device, seed=seed)
        self.nets = {"generator": s.generator, "d_pb": s.d_pb,
                     "d_pp": s.d_pp, "vgg": s.l1_loss.vgg}
        self.specs = gan_specs(self.nets)
        drawn = bw.draw(self.specs, seed, self.device)
        for prefix, net in self.nets.items():
            bw.load_into(net, drawn, prefix + ".")
        del drawn
        self.step_fn = make_train_step(s)
        self.loader = make_loader(cfg)
        self.prepare = make_prepare_batch(cfg.data.sigma, self.device)
        self.sched = LRSchedule(cfg)
        self.epoch = cfg.optim.epoch_count - 1
        self.batches = iter(())
        self.lr = cfg.optim.lr
        self.total = 0
        self.unit_per_step = self.loader.batch_size
        self.trace_after = t["trace_after"]
        self.trace_steps = t["trace_steps"]
        self.print_freq = cfg.run.print_freq
        self.got = self._checked_steps(t["checked_steps"])
        self._count_work()
        for _ in range(t["warmup_steps"]):
            self.step()
        self.total = 0

    # --- the loop --------------------------------------------------------

    def _next_raw(self) -> dict:
        while True:
            raw = next(self.batches, None)
            if raw is not None:
                return raw
            self.epoch += 1
            self.lr = self.sched.epoch_lr(
                self.epoch - self.cfg.optim.epoch_count, None)
            self.batches = iter(self.loader.epoch(self.epoch))

    def _one(self):
        with self.spans("loader"):
            raw = self._next_raw()
        with self.spans("prepare"):
            batch = self.prepare({k: v for k, v in raw.items()
                                  if not k.endswith("paths")})
        with self.spans("step"):
            metrics = self.step_fn(batch, self.lr)
        self.total += 1
        return raw, batch, metrics

    def step(self) -> int:
        _, _, metrics = self._one()
        if self.total % self.print_freq == 0:
            with self.spans("fetch"):
                {k: float(v) for k, v in metrics.items()}
        return self.unit_per_step

    # --- set-up ------------------------------------------------------------

    def _checked_steps(self, n: int) -> dict:
        s = self.system
        self.masks, self.paths, self.lrs = {}, [], []
        hooks = common.record_dropout_masks(
            {k: self.nets[k] for k in NETS}, self.masks)
        losses, grads = [], {}
        try:
            for i in range(n):
                raw, batch, metrics = self._one()
                self.paths.append((list(raw["src_paths"]),
                                   list(raw["tgt_paths"])))
                self.lrs.append(self.lr)
                losses.append({k: float(metrics[k]) for k in ref.LOSS_KEYS})
                if i == 0:
                    grads = common.first_grads(
                        [("generator", s.generator, s.opt_g),
                         ("d_pb", s.d_pb, s.opt_d_pb),
                         ("d_pp", s.d_pp, s.opt_d_pp)], self.cfg.optim.beta1)
                    self.k1_s = k1_bound_s(
                        torch.as_tensor(raw["tgt_uv"]), batch["P2"].shape[1],
                        batch["P2"].shape[2], self.cfg.data.sigma)
        finally:
            for h in hooks:
                h.remove()
        change = common.change_norms({k: self.nets[k] for k in NETS},
                                     bw.draw(self.specs, self.seed,
                                             self.device))
        return {"losses": losses, "grad_norms": grads,
                "change_norms": change}

    def _count_work(self) -> None:
        """One step under the FLOP counter and the BatchNorm sites."""
        flops = FlopCounter(self.nets.values())
        sites = BatchNormSites(self.nets.values())
        with flops.counting(), sites.recording():
            self.step()
        self.flops_per_step = flops.flops
        self.k2_s, self.k2b_s = sites.k2_s, sites.k2b_s

    # --- after the window -------------------------------------------------

    def release(self) -> None:
        if hasattr(self.batches, "close"):
            self.batches.close()
        for name in ("system", "step_fn", "nets", "loader", "batches",
                     "prepare"):
            setattr(self, name, None)
        common.free_cuda()

    def reference(self, quant=None, rows=None) -> dict:
        """The reference's reading of the checked steps: float32, or under
        ``quant``; with ``rows``, on the first ``rows`` samples only."""
        from benchmark.reference.layers import set_quant

        m = self.cell.config["model"]
        annos = load_annotations(self.root)
        with exact_f32():
            nets = ref.build_nets(m, self.cfg.loss.perceptual_layers,
                                  self.device)
            ref.load_weights(nets, bw.draw(self.specs, self.seed,
                                           self.device))
            for net in nets.values():
                set_quant(net, quant)
            set_masks({k: nets[k] for k in NETS},
                      MaskSource(self.masks, rows))
            batches = []
            for src, tgt in self.paths:
                b = ref.gan_batch(self.root, annos, src, tgt,
                                  self.cfg.data.sigma, self.device)
                batches.append({k: v[:rows] for k, v in b.items()})
            out = ref.train_steps(nets, batches, self.lrs, hyper(self.cfg))
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
