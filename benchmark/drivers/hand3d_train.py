"""The posenet loop of ``mmhand_torch.scripts.train_hand3d.main``, one step
at a time, over the packed GAN DB that ``create_hand3d_db`` makes of the
benchmark's tree: 8 indices a step, uniform with replacement
(``RandomState(seed)``), the records read by ``Hand3dBinaryDataset`` on
the loop's thread and stacked by ``records_to_pipeline_batch``,
``derive_batch`` with posenet's reader flags and a CPU noise generator
seeded ``seed + 1``, the step of ``make_hand3d_train_step(Hand3DSystem(
"posenet"))`` and the loss fetched to the host after every step, as
``main`` does; the saves left out.

Set-up: the DB is written on a checkout's first run and read once, so that
the window reads it from the page cache as a long run does; the system
is built once and takes the benchmark's weights (xavier-uniform from the
seed, drawn on the device, biases 1e-4); its first ``checked_steps`` steps
record what the check compares, with the uniforms the noise generator
drew; then one step counts the FLOPs and ``warmup_steps`` warm up.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.reference import compare
from benchmark.reference import hand3d as ref
from benchmark.reference.gan import load_weights
from benchmark.reference.layers import exact_f32, fp8, set_quant
from benchmark.roofline import FlopCounter

NET = "posenet"
BIAS = 1e-4
READ_CHUNK = 64 << 20


def db_path(n_items: int, size: int) -> str:
    """The packed DB of the cell's tree, written by the program's
    ``create_hand3d_db`` on the first run in this checkout."""
    path = common.CACHE_DIR / f"hand3d_db_{n_items}_{size}.bin"
    if not path.exists():
        from mmhand_torch.scripts import create_hand3d_db

        tree = common.tree_root(n_items, size)
        part = path.with_suffix(".part")
        create_hand3d_db.main(["--dataroot", tree, "--out", str(part)])
        os.replace(part, path)
    return str(path)


def read_through(path: str) -> None:
    """Read the file once, into the page cache."""
    with open(path, "rb", buffering=0) as fh:
        while fh.read(READ_CHUNK):
            pass


def xavier_specs(net: torch.nn.Module) -> list:
    """(name, shape, bound) of each weight, bound sqrt(6 / (fan_in +
    fan_out)); a bias has bound None."""
    specs = []
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            specs.append((name, tuple(p.shape), None))
        else:
            field = p[0, 0].numel()
            fans = (p.shape[0] + p.shape[1]) * field
            specs.append((name, tuple(p.shape), math.sqrt(6.0 / fans)))
    return specs


def draw_xavier(specs, seed: int, device) -> dict:
    """One uniform draw of a generator on ``device`` seeded ``seed``, cut
    into the weights of ``specs`` in order; biases 1e-4."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s) for _, s, b in specs if b is not None)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, bound in specs:
        if bound is None:
            out[name] = torch.full(shape, BIAS, device=device)
            continue
        n = math.prod(shape)
        out[name] = ((2.0 * u[at:at + n] - 1.0) * bound).view(shape)
        at += n
    return out


def ref_name(name: str) -> str:
    """The program's ``conv1_1.conv.weight`` as the reference's
    ``posenet.conv1_1.weight``."""
    return f"{NET}." + name.replace(".conv.", ".")


class Run:
    def __init__(self, cell, seed: int, spans, device="cuda"):
        from mmhand_torch.data.hand3d_binary import Hand3dBinaryDataset
        from mmhand_torch.hand3d import (
            Hand3DSystem,
            derive_batch,
            make_hand3d_train_step,
        )
        from mmhand_torch.scripts.train_hand3d import (
            pipeline_config_for,
            records_to_pipeline_batch,
        )

        c, t = cell.config, cell.traffic
        if c["precision"]["compute_dtype"] != "float32":
            raise ValueError("the hand3d nets train in float32 only")
        self.cell, self.seed, self.spans = cell, seed, spans
        self.device = torch.device(device)
        self.size = size = c["model"]["fine_size"]
        self.db = db_path(t["tree_items"], size)
        read_through(self.db)
        self.system = Hand3DSystem(NET, crop_size=size, device=self.device,
                                   seed=seed)
        self.specs = xavier_specs(self.system.module)
        drawn = draw_xavier(self.specs, seed, self.device)
        with torch.no_grad():
            for name, p in self.system.module.named_parameters():
                p.copy_(drawn[name])
        del drawn
        self.step_fn = make_hand3d_train_step(self.system)
        self.dataset = Hand3dBinaryDataset(self.db, size, size)
        self.n = len(self.dataset)
        self.derive = derive_batch
        self.stack = records_to_pipeline_batch
        self.pipeline = pipeline_config_for(NET, (size, size), size)
        para, p = self.system.train_para, self.pipeline
        if ([para["lr"], para["lr_iter"], p.sigma, p.coord_uv_noise_sigma]
                != [c["optim"]["lr"], c["optim"]["lr_iter"],
                    c["scoremap_sigma"], c["uv_noise_sigma"]]):
            raise ValueError("the program does not run the configuration")
        self.rng = np.random.RandomState(seed % 2 ** 32)
        self.noise = torch.Generator().manual_seed(seed + 1)
        self.batch_size = c["batch_size"]
        self.unit_per_step = self.batch_size
        self.trace_after = t["trace_after"]
        self.trace_steps = t["trace_steps"]
        self.got = self._checked_steps(t["checked_steps"])
        flops = FlopCounter([self.system.module])
        with flops.counting():
            self.step()
        self.flops_per_step = flops.flops
        for _ in range(t["warmup_steps"]):
            self.step()

    def _one(self):
        with self.spans("loader"):
            idx = self.rng.randint(0, self.n, self.batch_size)
            raw = self.stack([self.dataset[int(i)] for i in idx])
        drew = self.noise.get_state()
        with self.spans("derive"):
            batch = self.derive(raw, self.pipeline, self.noise, self.device)
        with self.spans("step"):
            loss = self.step_fn(batch)
        with self.spans("fetch"):
            loss = float(loss)
        return idx, drew, loss

    def step(self) -> int:
        self._one()
        return self.unit_per_step

    def _checked_steps(self, n: int) -> dict:
        losses, grads = [], {}
        self.indices, self.uniforms = [], []
        self.first_step = self.system.step
        for i in range(n):
            idx, drew, loss = self._one()
            self.indices.append(idx)
            # the uniforms derive_batch's one draw (the uv noise) took
            gen = torch.Generator()
            gen.set_state(drew)
            self.uniforms.append(torch.rand((len(idx), ref.N_KP, 2),
                                            generator=gen))
            losses.append({"loss": loss})
            if i == 0:
                first = common.first_grads(
                    [(NET, self.system.module, self.system.opt)],
                    ref.BETAS[0])
                grads = {ref_name(k.split(".", 1)[1]): v
                         for k, v in first.items()}
        start = draw_xavier(self.specs, self.seed, self.device)
        with torch.no_grad():
            change = {ref_name(k): float((p - start[k]).norm())
                      for k, p in self.system.module.named_parameters()}
        return {"losses": losses, "grad_norms": grads,
                "change_norms": change}

    def release(self) -> None:
        for name in ("system", "step_fn", "dataset"):
            setattr(self, name, None)
        common.free_cuda()

    def reference(self, quant=None, rows=None) -> dict:
        weights = {ref_name(k): v for k, v in draw_xavier(
            self.specs, self.seed, self.device).items()}
        with exact_f32():
            net = ref.PoseNet2D().to(self.device)
            load_weights({NET: net}, weights)
            del weights
            set_quant(net, quant)
            batches = []
            for idx, u in zip(self.indices, self.uniforms):
                records = ref.read_records(self.db, idx[:rows], self.size)
                batches.append(ref.posenet_batch(records, u[:rows],
                                                 self.size, self.device))
            out = ref.train_steps(net, batches, self.first_step)
        del net, batches
        common.free_cuda()
        return out

    def check(self) -> dict:
        numbers = compare.train_gaps(self.got, self.reference())
        return compare.with_limits(numbers, self.cell.limits)

    def control_readings(self) -> dict:
        """The check's numbers for the program, for the reference in
        float8 put in its place (the control), and for half of each batch
        left out, each against the float32 reference."""
        want = self.reference()
        rows = self.cell.config["batch_size"] // 2
        return compare.control_readings(self.got, want, {
            "fp8": self.reference(quant=fp8),
            "half_batch": self.reference(rows=rows)})
