"""mmhand_torch's data-parallel training over torch.distributed, 2 ranks
over gloo on the CPU, against mmhand_tpu's single-device full batch (the
twins of tests/test_train.py:179 and :215).

Each multi-process test launches ``_WORKER`` (it imports only the port) as
two ranks with torchrun's environment through
``mmhand_torch.parallel.dryrun.launch``, under a 120 s timeout; the parent
computes the JAX side and compares what the ranks saved.  Tolerances:
BatchNorm outputs and input gradients atol 1e-5 (f32 sums in another
order); the G forward atol 1e-4 as tests/test_train.py:179; the DP step
within tests/test_torch_train.py's per-network bound on elements that Adam's
rounding decides.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch import config as tcfg
from mmhand_torch.convert import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from mmhand_torch.models.layers import BatchNorm2d
from mmhand_torch.parallel import init_distributed
from mmhand_torch.parallel.dryrun import dryrun_multichip, launch, params_agree
from mmhand_torch.parallel.sharding import flat_grads
from mmhand_torch.train.state import build_system
from mmhand_torch.utils.checkpoint import CheckpointManager
from mmhand_tpu import config as jcfg
from mmhand_tpu.models import Generator as JaxGenerator
from mmhand_tpu.models import NormConfig as JaxNormConfig
from mmhand_tpu.train import state as jstate
from mmhand_tpu.train import step as jstep
from test_torch_threads import two_threads  # noqa: F401

WORLD, B, SIZE, LR = 2, 4, 32, 2e-4
NETS = ("generator", "d_pb", "d_pp")
ENV = {"OMP_NUM_THREADS": "1",
       "PYTHONPATH": str(Path(__file__).resolve().parent.parent)}

_WORKER = r'''
import sys
import torch
import torch.distributed as dist

import mmhand_torch.train.step as tstep
from mmhand_torch import config as tcfg
from mmhand_torch.models.generator import Generator
from mmhand_torch.models.layers import BatchNorm2d, NormConfig
from mmhand_torch.parallel import init_distributed
from mmhand_torch.train.state import build_system
from mmhand_torch.train.step import make_train_step
from mmhand_torch.utils import trace
from mmhand_torch.utils.checkpoint import CheckpointManager

case, tmp = sys.argv[1], sys.argv[2]
init_distributed("cpu")
rank = dist.get_rank()
data = torch.load(f"{tmp}/in.pt", weights_only=False)
half = lambda x: x[2 * rank:2 * rank + 2]
out = {}


def system(scaling=False, pool=0):
    """tests' _config(tcfg, scaling, pool)"""
    cfg = tcfg.Config(
        model=tcfg.ModelConfig(fine_size=32, g_n_blocks=1, ngf=8, ndf=8,
                               use_dropout_g=False, use_dropout_d=False),
        loss=tcfg.LossConfig(l1_type="origin"),
        optim=tcfg.OptimConfig(pool_size=pool),
        precision=tcfg.PrecisionConfig(compute_dtype="float32",
                                       loss_scaling=scaling))
    s = build_system(cfg, "cpu", distributed=True)
    for name, sd in data["nets"].items():
        getattr(s, name).load_state_dict(sd)
    return s


def net_dicts(s):
    return {n: getattr(s, n).state_dict() for n in ("generator", "d_pb", "d_pp")}


if case == "syncbn":
    bn = BatchNorm2d(data["x"].shape[1], cross_rank=True)
    bn.load_state_dict(data["bn"])
    x = half(data["x"]).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    y = bn(x)
    (y * half(data["w"])).sum().backward()
    out.update(y=y.detach(), grad=x.grad, bn=bn.state_dict())
    g = Generator(ngf=8, n_blocks=1, use_dropout=False,
                  norm=NormConfig(kind="batch", cross_rank=True),
                  compute_dtype=None)
    g.load_state_dict(data["g"])
    g = g.to(memory_format=torch.channels_last).train()
    out["fake"] = g(tuple(half(x) for x in data["g_in"])).detach()
elif case == "dpstep":
    s = system()
    trace.enable()
    m = make_train_step(s)({k: half(v) for k, v in data["batch"].items()}, 2e-4)
    spans = sorted(trace.spans(), key=lambda sp: sp.start_ns)
    out.update(nets=net_dicts(s), metrics={k: float(v) for k, v in m.items()},
               phases=[(sp.name, [c.name for c in spans if c.parent == sp.id])
                       for sp in spans if sp.name in ("g_phase", "d_phase")])
elif case == "overflow":
    s = system(scaling=True)
    before = net_dicts(s)
    before = {n: {k: v.clone() for k, v in sd.items()} for n, sd in before.items()}
    if rank == 1:  # only this rank's G gradients overflow
        real = tstep.grads_overflow
        calls = []
        def flag(g):
            calls.append(1)
            return torch.tensor(True) if len(calls) == 1 else real(g)
        tstep.grads_overflow = flag
    m = make_train_step(s)({k: half(v) for k, v in data["batch"].items()}, 2e-4)
    moved = [f"{n}.{k}" for n, sd in net_dicts(s).items() for k, v in sd.items()
             if "running" not in k and not k.endswith("num_batches_tracked")
             and not torch.equal(v, before[n][k])]
    out.update(metrics={k: float(v) for k, v in m.items()}, moved=moved,
               steps=[len(o.state) for o in (s.opt_g, s.opt_d_pp, s.opt_d_pb)],
               scales={k: (float(v.scale), int(v.growth_count))
                       for k, v in s.scales.items()})
elif case == "saveresume":
    s = system(scaling=True, pool=3)
    step = make_train_step(s)
    for b in data["batches"]:
        step({k: half(v) for k, v in b.items()}, 2e-4)
    ckpt = CheckpointManager(tmp, "dp")
    ckpt.save(s, "latest")
    out["saved"] = s.state_dict()
    fresh = system(scaling=True, pool=3)
    ckpt.restore(fresh, "latest")
    out["restored"] = fresh.state_dict()
torch.save(out, f"{tmp}/out{rank}.pt")
dist.destroy_process_group()
'''


def _config(module, scaling=False, pool=0):
    return module.Config(
        model=module.ModelConfig(fine_size=SIZE, g_n_blocks=1, ngf=8, ndf=8,
                                 use_dropout_g=False, use_dropout_d=False),
        loss=module.LossConfig(l1_type="origin"),
        optim=module.OptimConfig(pool_size=pool),
        precision=module.PrecisionConfig(compute_dtype="float32",
                                         loss_scaling=scaling))


def _batch(seed=5):
    r = np.random.RandomState(seed)
    return {k: r.uniform(-1, 1, (B, SIZE, SIZE, c)).astype(np.float32)
            for k, c in [("H1", 3), ("H2", 3), ("D1", 3), ("D2", 3),
                         ("P1", 21), ("P2", 21)]}


def _numpy(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


@functools.lru_cache(maxsize=None)
def _jax_init():
    system = jstate.MMHandSystem(_config(jcfg))
    state = jax.jit(system.init_state, static_argnames="local_batch_size")(
        jax.random.PRNGKey(0), local_batch_size=2)
    nets = {"generator": generator_state_dict_from_jax(
                {"params": _numpy(state.g.params),
                 "batch_stats": _numpy(state.g.batch_stats)},
                use_dropout=False)}
    for name, net in (("d_pb", state.d_pb), ("d_pp", state.d_pp)):
        nets[name] = discriminator_state_dict_from_jax(
            {"params": _numpy(net.params),
             "batch_stats": _numpy(net.batch_stats)}, use_dropout=False)
    return system, state, nets


def _run(tmp_path, case, **inputs):
    """``_WORKER case`` as 2 ranks over gloo; returns each rank's outputs."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    torch.save(inputs, tmp_path / "in.pt")
    launch([str(worker), case, str(tmp_path)], WORLD, timeout=120, env=ENV)
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_sync_bn_and_generator_match_the_full_batch(tmp_path):
    """Sync-BN on half batches: the output, the input gradient and the
    running statistics equal the single-process BatchNorm on the full batch;
    the 2-rank G forward in train mode equals JAX's full-batch forward (the
    twin of tests/test_train.py:179)."""
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.normal(0.3, 1.5, (B, 16, 8, 8)).astype(np.float32))
    w = torch.from_numpy(r.normal(0, 1, (B, 16, 8, 8)).astype(np.float32))
    bn = BatchNorm2d(16)
    with torch.no_grad():
        bn.weight.normal_(1.0, 0.1)
        bn.bias.normal_(0.0, 0.1)
    g_in = tuple(r.uniform(-1, 1, (B, SIZE, SIZE, c)).astype(np.float32)
                 for c in (3, 42, 6))
    jg = JaxGenerator(ngf=8, n_blocks=1, use_dropout=False,
                      norm=JaxNormConfig(kind="batch"), dtype=jnp.float32)
    xs = tuple(jnp.asarray(a) for a in g_in)
    variables = jax.jit(functools.partial(jg.init, train=False))(
        jax.random.PRNGKey(0), xs)
    want_fake = np.asarray(jax.jit(functools.partial(
        jg.apply, train=True, mutable=["batch_stats"]))(variables, xs)[0])

    outs = _run(tmp_path, "syncbn", x=x, w=w, bn=bn.state_dict(),
                g=generator_state_dict_from_jax(_numpy(dict(variables)),
                                                use_dropout=False),
                g_in=tuple(torch.from_numpy(a) for a in g_in))

    xr = x.clone().contiguous(memory_format=torch.channels_last)
    xr.requires_grad_(True)
    y = bn.train()(xr)
    (y * w).sum().backward()
    np.testing.assert_allclose(torch.cat([o["y"] for o in outs]).numpy(),
                               y.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(torch.cat([o["grad"] for o in outs]).numpy(),
                               xr.grad.numpy(), atol=1e-5)
    for o in outs:
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(o["bn"][k].numpy(),
                                       bn.state_dict()[k].numpy(), atol=1e-6)
    fake = torch.cat([o["fake"] for o in outs]).numpy()
    assert fake.shape == (B, SIZE, SIZE, 3)
    np.testing.assert_allclose(fake, want_fake, atol=1e-4)


def _assert_close(got: dict, want: dict, updates: int):
    """tests/test_torch_train.py's per-network bound."""
    for name in NETS:
        outside = total = 0
        for k, v in want[name].items():
            if k.endswith("num_batches_tracked"):
                continue
            a, b = got[name][k].numpy(), v.numpy()
            diff = np.abs(a - b)
            tol = (1e-5 if "running" in k else 2e-5) + 1e-3 * np.abs(b)
            outside += int((diff > tol).sum())
            total += b.size
            assert diff.max() <= 2 * LR * updates, f"{name}.{k} {diff.max()}"
        assert outside <= 0.005 * total, f"{name}: {outside} of {total}"


def test_dp_step_matches_jax_full_batch(tmp_path):
    """One DP step on 2 ranks (pool 0, dropout off, f32) against JAX's
    single-device step on the whole batch: the losses, and every parameter
    and running statistic after the three Adam updates (the twin of
    tests/test_train.py:215).  Both ranks end with the same networks, and
    each phase of each rank exchanged its gradients in an ``allreduce``
    span between its ``backward`` and its ``adam``."""
    system, state, nets = _jax_init()
    batch = _batch()
    step = jax.jit(jstep.make_train_step(system, None))
    after, want = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, LR)
    outs = _run(tmp_path, "dpstep", nets=nets,
                batch={k: torch.from_numpy(v) for k, v in batch.items()})
    for k, v in want.items():
        np.testing.assert_allclose(outs[0]["metrics"][k], float(v), rtol=2e-4,
                                   atol=2e-4, err_msg=k)
    assert outs[0]["metrics"] == outs[1]["metrics"]
    update = ["backward", "allreduce", "adam"]
    for o in outs:
        assert o["phases"] == [("g_phase", update), ("d_phase", update),
                               ("d_phase", update)]
    want_nets = {
        "generator": generator_state_dict_from_jax(
            {"params": _numpy(after.g.params),
             "batch_stats": _numpy(after.g.batch_stats)}, use_dropout=False),
        **{name: discriminator_state_dict_from_jax(
            {"params": _numpy(net.params),
             "batch_stats": _numpy(net.batch_stats)}, use_dropout=False)
           for name, net in (("d_pb", after.d_pb), ("d_pp", after.d_pp))}}
    _assert_close(outs[0]["nets"], want_nets, 1)
    for name in NETS:
        for k, v in outs[0]["nets"][name].items():
            assert torch.equal(v, outs[1]["nets"][name][k]), f"{name}.{k}"


def test_overflow_on_one_rank_skips_both(tmp_path):
    """Rank 1 alone flags its G gradients: the OR-vote makes both ranks skip
    the G, D_PP and D_PB updates and back off G's scale."""
    _, _, nets = _jax_init()
    outs = _run(tmp_path, "overflow", nets=nets,
                batch={k: torch.from_numpy(v) for k, v in _batch().items()})
    for o in outs:
        assert o["metrics"]["amp_overflow"] == 1.0
        assert o["moved"] == []
        assert o["steps"] == [0, 0, 0]  # no Adam step anywhere
        assert o["scales"] == {"g": (2.0 ** 15, 0), "d_pp": (2.0 ** 16, 1),
                               "d_pb": (2.0 ** 16, 1)}


def test_two_rank_save_and_resume_slice_each_rank(tmp_path):
    """A 2-rank checkpoint stacks each rank's pools and random streams; a
    2-rank restore gives each rank its own row back, bit for bit.  Resuming
    it in one process raises."""
    _, _, nets = _jax_init()
    r = np.random.RandomState(9)
    batches = [{k: torch.from_numpy(r.uniform(-1, 1, (B, SIZE, SIZE, c))
                                    .astype(np.float32))
                for k, c in [("H1", 3), ("H2", 3), ("D1", 3), ("D2", 3),
                             ("P1", 21), ("P2", 21)]} for _ in range(2)]
    outs = _run(tmp_path, "saveresume", nets=nets,
                batches=batches)
    saved = torch.load(tmp_path / "dp" / "state_latest.pt", weights_only=True)
    assert saved["world"] == WORLD and saved["step"] == 2
    assert saved["rank"]["pool_pb"].shape == (WORLD, 3, SIZE, SIZE, 24)
    assert not torch.equal(saved["rank"]["pool_pb"][0],
                           saved["rank"]["pool_pb"][1])
    for rank, o in enumerate(outs):
        for k, v in o["saved"]["rank"].items():
            assert torch.equal(saved["rank"][k][rank], v), k
            assert torch.equal(o["restored"]["rank"][k], v), k
        for name in NETS:
            for k, v in o["saved"][name].items():
                assert torch.equal(o["restored"][name][k], v)
        assert o["restored"]["step"] == 2
    single = build_system(_config(tcfg, True, 3), "cpu")
    with pytest.raises(ValueError, match="saved by 2 ranks"):
        CheckpointManager(str(tmp_path), "dp").restore(single)


def test_train_cli_multihost_over_gloo(tmp_path):
    """python -m mmhand_torch.scripts.train --multihost as 2 gloo ranks:
    rank 0 alone prints the loss lines and writes the logs, the ranks share
    the global batch, and the checkpoint holds both ranks' pools."""
    outs = launch(["-m", "mmhand_torch.scripts.train", "--multihost",
                   "--device", "cpu", "--dataset", "synthetic", "--batchSize",
                   "4", "--fineSize", "32", "--ngf", "8", "--ndf", "8",
                   "--n_layers_D", "1", "--L1_type", "origin",
                   "--pool_size", "2", "--max_steps", "2", "--print_freq", "1",
                   "--checkpoints_dir", str(tmp_path), "--name", "cli"],
                  WORLD, timeout=120, env=ENV)
    assert outs[0].count("(epoch: 1, iters: ") == 2 and "done: 2 steps" in outs[0]
    assert "(epoch:" not in outs[1] and "done:" not in outs[1]
    saved = torch.load(tmp_path / "cli" / "state_latest.pt", weights_only=True)
    assert saved["world"] == WORLD and saved["step"] == 2
    assert saved["rank"]["pool_pp"].shape == (WORLD, 2, SIZE, SIZE, 6)
    assert (saved["rank"]["pool_pp_num"] == 2).all()
    log = (tmp_path / "cli" / "loss_log.txt").read_text()
    assert log.count("(epoch: 1, iters: ") == 2


def test_dryrun_multichip_two_ranks():
    """The GAN, HPE (hpm) and hand3d lifting DP steps of
    __graft_entry__.py's dry run, in one launch of two gloo ranks."""
    metrics = dryrun_multichip(2)
    assert set(metrics) == {"gan", "hpe", "hand3d"}
    assert set(metrics["gan"]) == {"pair_L1loss", "pair_GANloss", "origin_L1",
                                   "perceptual", "D_PP", "D_PB"}
    assert set(metrics["hpe"]) == {"mse", "lz"}
    assert set(metrics["hand3d"]) == {"loss"}
    assert all(np.isfinite(v) for leg in metrics.values() for v in leg.values())


def test_missing_gradient_and_environment_raise(monkeypatch):
    """A parameter without a gradient fails the all-reduce instead of being
    skipped, and init_distributed names the torchrun variables it lacks."""
    params = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))]
    params[0].grad = torch.ones(3)
    with pytest.raises(RuntimeError, match="no gradient"):
        flat_grads(params)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        init_distributed("cpu")


@pytest.mark.parametrize("change,agree", [
    ("none", True),
    ("one_outside", True),      # 1 of 1,100 elements: within the 0.5%
    ("ten_outside", False),     # 10 of 1,100: beyond it
    ("one_far", False),         # past 2 lr an update
    ("weights_inside", True),   # every weight 1.5e-5 off: inside 2e-5
    ("running_outside", False),  # running statistics 1.5e-5 off: past 1e-5
])
def test_params_agree_holds_the_update_rule(change, agree):
    gen = torch.Generator().manual_seed(0)
    want = {"w": torch.randn(1000, generator=gen),
            "bn.running_mean": torch.zeros(100),
            "bn.num_batches_tracked": torch.tensor(3)}
    got = {k: v.clone() for k, v in want.items()}
    got["bn.num_batches_tracked"] += 1  # not compared
    lr, updates = 1e-3, 2
    if change == "one_outside":
        got["w"][0] += 1e-3
    elif change == "ten_outside":
        got["w"][:10] += 1e-3 + 1e-3 * want["w"][:10].abs()
    elif change == "one_far":
        got["w"][0] += 2.5 * lr * updates
    elif change == "running_outside":
        got["bn.running_mean"] += 1.5e-5
    elif change == "weights_inside":
        got["w"] += 1.5e-5
    ok, line = params_agree(got, want, updates, lr)
    assert ok is agree, line

