"""The GAN train step and the generator's eval step (counterpart of
mmhand_tpu/train/step.py).

The update schedule is the reference's (reference models/MMHandModel.py:
310-330) in the JAX package's order (mmhand_tpu/train/step.py:205-318): one
generator forward in train mode, the G loss (L1 + perceptual + both
discriminators on the fake), the G Adam update; then DG_ratio x (pool query,
D_PP step) and DG_ratio x (pool query, D_PB step), both on the fake of the
*pre-update* generator, detached.

JAX differentiates only the generator's parameters in the G phase and throws
away the batch-statistic updates of the discriminator forwards there
(:224-236).  Here the discriminators' parameters stop requiring gradients for
that phase, so no weight-gradient convolution of theirs runs and nothing
reaches their optimizers, and their BatchNorms keep their running statistics
(``frozen_running_stats``).  Each D step runs its real forward, then its fake
forward, both updating the running statistics (:171-186).

Every update runs backward, then, with PrecisionConfig.loss_scaling, the
scaled-loss path of mmhand_tpu/train/step.py:181-201 (scale the loss,
unscale the gradients, OR-vote a non-finite gradient across ranks, update the
phase's scale, skip ``opt.step()`` once the step has overflowed, so Adam's
count and moments stay as they were); then, over several ranks, the
gradients averaged across them (mmhand_tpu's ``psync``), then
``opt.step()``.  The overflow flag costs one host sync per phase, on this
path only.

Loss contract (reference get_current_errors, MMHandModel.py:332-341): the six
keys pair_L1loss, pair_GANloss, origin_L1, perceptual, D_PP, D_PB, with D_*
from the last of the DG_ratio iterations, as 0-d tensors on the device,
unscaled and averaged over the ranks; with loss scaling, also
``amp_overflow`` (1.0 when the step's updates were skipped).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from mmhand_torch.losses.gan import gan_loss
from mmhand_torch.models.generator import Generator
from mmhand_torch.models.layers import frozen_running_stats
from mmhand_torch.parallel.sharding import (
    all_reduce_grads,
    all_reduce_mean_,
    any_rank,
    flat_grads,
    mean_metrics,
    set_grads_,
)
from mmhand_torch.train.pool import pool_query_random
from mmhand_torch.train.precision import grads_overflow, unscale_, update_scale
from mmhand_torch.train.state import MMHandSystem


def lr_for_epoch(cfg, epoch: int) -> float:
    """Per-epoch LR of the stateless policies
    (reference models/network_utils.py:87-101).

    lambda: linear decay to zero over niter_decay epochs after niter.
    step: x0.1 every lr_decay_iters epochs.
    plateau is stateful: use LRSchedule.
    """
    o = cfg.optim
    if o.lr_policy == "lambda":
        mult = 1.0 - max(0, epoch + 1 + o.epoch_count - o.niter) / float(
            o.niter_decay + 1)
        return o.lr * mult
    if o.lr_policy == "step":
        return o.lr * (0.1 ** (epoch // o.lr_decay_iters))
    raise NotImplementedError(f"lr policy [{o.lr_policy}]")


class LRSchedule:
    """Stateful per-epoch LR schedule of all three reference policies
    (reference models/network_utils.py:87-109; mmhand_tpu/train/step.py:62).

    ``epoch_lr(epoch, metric)`` returns the LR of the coming epoch; ``metric``
    is last epoch's mean G objective and only the plateau policy reads it:
    ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01 rel,
    patience=5, cooldown=0).  The reference could never run plateau (its
    ``scheduler.step()`` passes no metric, reference models/base_model.py:
    83-87); the port implements the policy the flag promises, as mmhand_tpu.
    """

    FACTOR = 0.2
    THRESHOLD = 0.01
    PATIENCE = 5

    def __init__(self, cfg):
        self.cfg = cfg
        self.policy = cfg.optim.lr_policy
        self._lr = cfg.optim.lr
        self._best = float("inf")
        self._num_bad = 0
        if self.policy not in ("lambda", "step", "plateau"):
            raise NotImplementedError(f"lr policy [{self.policy}]")

    def epoch_lr(self, epoch: int, metric: Optional[float] = None) -> float:
        if self.policy != "plateau":
            return lr_for_epoch(self.cfg, epoch)
        if metric is not None:
            if metric < self._best * (1.0 - self.THRESHOLD):
                self._best = metric
                self._num_bad = 0
            else:
                self._num_bad += 1
            if self._num_bad > self.PATIENCE:
                self._lr *= self.FACTOR
                self._num_bad = 0
        return self._lr

    def state_dict(self) -> dict:
        return {"lr": self._lr, "best": self._best, "num_bad": self._num_bad}

    def load_state_dict(self, d: dict) -> None:
        self._lr, self._best, self._num_bad = (
            d["lr"], d["best"], d["num_bad"])


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


@contextlib.contextmanager
def _as_loss(*nets: torch.nn.Module):
    """``nets`` as fixed parts of another network's loss: no gradients for
    their parameters, no running-statistic updates."""
    for net in nets:
        net.requires_grad_(False)
    try:
        with frozen_running_stats(*nets):
            yield
    finally:
        for net in nets:
            net.requires_grad_(True)


class TrainStep:
    """``step(batch, lr) -> metrics`` over a MMHandSystem; ``batch`` is a dict
    of NHWC float32 tensors H1, P1, D1, H2, P2, D2 on the system's device.
    The phases are methods, so that each can be timed alone."""

    def __init__(self, system: MMHandSystem):
        self.system = system
        loss = system.config.loss
        self.lam_gan = loss.lambda_gan
        self.gan_mode = loss.gan_mode
        self.dg_ratio = system.config.optim.dg_ratio
        # the step's sticky overflow flag (0-d bool), with loss scaling
        self.overflow: Optional[torch.Tensor] = None

    def __call__(self, batch: dict, lr: float) -> dict:
        fake, metrics = self.g_phase(batch, lr)
        h1, h2, p2 = batch["H1"], batch["H2"], batch["P2"]
        real_pp = torch.cat([h2, h1], -1)
        fake_pp = torch.cat([fake, h1], -1)
        for _ in range(self.dg_ratio):
            loss_d_pp = self.d_phase("pp", real_pp, self.replay("pp", fake_pp),
                                     lr)
        real_pb = torch.cat([h2, p2], -1)
        fake_pb = torch.cat([fake, p2], -1)
        for _ in range(self.dg_ratio):
            loss_d_pb = self.d_phase("pb", real_pb, self.replay("pb", fake_pb),
                                     lr)
        self.system.step += 1
        metrics = dict(metrics, D_PP=loss_d_pp, D_PB=loss_d_pb)
        if self.system.scales is not None:
            metrics["amp_overflow"] = self.overflow.float()
        if self.system.distributed:
            metrics = mean_metrics(metrics)
        return metrics

    def update(self, which: str, net: torch.nn.Module,
               opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
        """Backward of ``loss`` and ``opt.step()`` of ``net``; ``which`` names
        the loss's scaler: 'g', 'd_pp' or 'd_pb'.  The G phase starts the
        step's overflow flag, the D phases add to it."""
        s = self.system
        if s.scales is None:
            loss.backward()
            if s.distributed:
                all_reduce_grads(net)
            opt.step()
            return
        scale = s.scales[which]
        (loss * scale.scale).backward()
        params = [p for p in net.parameters() if p.requires_grad]
        flat = unscale_(flat_grads(params), scale)
        overflow = grads_overflow(flat)
        if s.distributed:
            overflow = any_rank(overflow)
        s.scales[which] = update_scale(scale, overflow)
        self.overflow = (overflow if which == "g"
                         else self.overflow | overflow)
        if s.distributed:
            all_reduce_mean_(flat)
        set_grads_(params, flat)
        if not bool(self.overflow):  # the phase's host sync
            opt.step()

    def l1_terms(self, fake, real):
        """(pair_L1loss, origin_L1, perceptual)."""
        if self.system.l1_loss is None:
            # --L1_type origin: plain unweighted L1 (reference :81-82)
            l1 = (fake - real).abs().mean()
            return l1, l1, torch.zeros((), dtype=torch.float32,
                                       device=fake.device)
        return self.system.l1_loss(fake, real)

    def g_phase(self, batch: dict, lr: float):
        """One G update; returns the detached pre-update fake and the four
        G metrics."""
        s = self.system
        for net in (s.generator, s.d_pb, s.d_pp):
            net.train()
        h1, h2, p2 = batch["H1"], batch["H2"], batch["P2"]
        g_in = (h1, torch.cat([batch["P1"], p2], -1),
                torch.cat([batch["D1"], batch["D2"]], -1))
        _set_lr(s.opt_g, lr)
        s.opt_g.zero_grad(set_to_none=True)
        with _as_loss(s.d_pb, s.d_pp):
            fake = s.generator(g_in)
            pred_pb = s.d_pb(torch.cat([fake, p2], -1))
            pred_pp = s.d_pp(torch.cat([fake, h1], -1))
        loss_gan_pb = gan_loss(pred_pb, True, self.gan_mode)
        loss_gan_pp = gan_loss(pred_pp, True, self.gan_mode)
        pair_l1, origin_l1, percep = self.l1_terms(fake, h2)
        pair_gan = (loss_gan_pb * self.lam_gan + loss_gan_pp * self.lam_gan) / 2.0
        self.update("g", s.generator, s.opt_g, pair_l1 + pair_gan)
        metrics = {"pair_L1loss": pair_l1, "pair_GANloss": pair_gan,
                   "origin_L1": origin_l1, "perceptual": percep}
        return fake.detach(), {k: v.detach() for k, v in metrics.items()}

    def replay(self, which: str, images: torch.Tensor) -> torch.Tensor:
        """Query pool ``which`` ('pp' or 'pb') with a batch of fakes."""
        s = self.system
        name = f"pool_{which}"
        state, out = pool_query_random(getattr(s, name), images, s.pool_rng)
        setattr(s, name, state)
        return out

    def d_phase(self, which: str, real: torch.Tensor, fake: torch.Tensor,
                lr: float) -> torch.Tensor:
        """One step of D_PP or D_PB (reference backward_D_basic :263-274)."""
        s = self.system
        net, opt = ((s.d_pp, s.opt_d_pp) if which == "pp"
                    else (s.d_pb, s.opt_d_pb))
        _set_lr(opt, lr)
        opt.zero_grad(set_to_none=True)
        loss_real = gan_loss(net(real), True, self.gan_mode) * self.lam_gan
        loss_fake = gan_loss(net(fake), False, self.gan_mode) * self.lam_gan
        loss = (loss_real + loss_fake) * 0.5
        self.update(f"d_{which}", net, opt, loss)
        return loss.detach()


def make_train_step(system: MMHandSystem) -> TrainStep:
    return TrainStep(system)


def make_eval_step(generator: Generator):
    """Generator-only forward for aug/eval (reference MMHandModel.test
    :223-230, aug.py:49-53): batch dict of NHWC tensors -> (B, H, W, 3)
    float32 fakes, in eval mode under ``torch.inference_mode``."""

    def eval_step(batch: dict) -> torch.Tensor:
        generator.eval()
        with torch.inference_mode():
            g_in = (batch["H1"],
                    torch.cat([batch["P1"], batch["P2"]], dim=-1),
                    torch.cat([batch["D1"], batch["D2"]], dim=-1))
            return generator(g_in)

    return eval_step
