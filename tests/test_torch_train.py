"""mmhand_torch's GAN train step, LR schedules and train CLI against
mmhand_tpu.

The step runs on both sides from the same weights (drawn by JAX, carried
over with mmhand_torch/convert.py) and the same numpy batches, in float32
with dropout off and pool 0 (their random streams cannot agree), as
tests/test_torch_parity.py:360-431 holds the reference trainer.  The two
frameworks sum convolution taps and batch statistics in another order, so
the tolerances are that test's: losses rtol/atol 2e-4; gradients (plain
descent) rtol 1e-3, atol 1e-5; parameters
after Adam rtol 1e-3, atol 2e-5, and running statistics rtol 1e-3, atol
1e-5, on all but 0.5% of each network's elements.  Adam divides each
gradient by its own running magnitude, so an element whose gradient is near
zero, or changes sign from update to update, takes an update that f32
rounding decides: perturbing the port's own weights by one f32 ulp leaves
0.2-0.4% of a discriminator's elements outside these tolerances after three
steps at DG_ratio 2.  Those elements are held within 2 lr per update, the
widest gap an update can open.  A leaked running-statistic update or a wrong
gradient moves far more than 0.5% of a network.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmhand_torch import config as tcfg
from mmhand_torch.convert import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    vgg_state_dict_from_jax,
)
from mmhand_torch.data import build_dataset
from mmhand_torch.scripts import aug as port_aug
from mmhand_torch.scripts import train as port_train
from mmhand_torch.train import state as tstate
from mmhand_torch.train import step as tstep
from mmhand_tpu import config as jcfg
from mmhand_tpu.train import state as jstate
from mmhand_tpu.train import step as jstep

B, SIZE, NGF, BLOCKS, LR = 2, 32, 8, 2, 2e-4
LOSS_KEYS = {"pair_L1loss", "pair_GANloss", "origin_L1", "perceptual",
             "D_PP", "D_PB"}


def _config(module, dg_ratio=1, **optim):
    return module.Config(
        model=module.ModelConfig(ngf=NGF, ndf=NGF, g_n_blocks=BLOCKS,
                                 n_layers_d=BLOCKS, fine_size=SIZE,
                                 use_dropout_g=False, use_dropout_d=False),
        optim=module.OptimConfig(pool_size=0, dg_ratio=dg_ratio, **optim),
        precision=module.PrecisionConfig(compute_dtype="float32"))


def _batch(seed):
    r = np.random.RandomState(seed)

    def mk(c, lo):
        return r.uniform(lo, 1, (B, SIZE, SIZE, c)).astype(np.float32)

    return {"H1": mk(3, -1), "P1": mk(21, 0), "D1": mk(3, -1),
            "H2": mk(3, -1), "P2": mk(21, 0), "D2": mk(3, -1)}


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The JAX networks and VGG weights, drawn once per process; a jitted
    init builds them in under half the time of flax's eager one."""
    system = jstate.MMHandSystem(_config(jcfg))
    state = jax.jit(system.init_state, static_argnames="local_batch_size")(
        jax.random.PRNGKey(0), local_batch_size=B)
    vgg_vars = system.make_l1_loss(None).init_vgg(jax.random.PRNGKey(1),
                                                  (1, SIZE, SIZE, 3))
    return state, vgg_vars


def _jax_side(dg_ratio, tx=None):
    """(initial state, jitted step, VGG variables) of the JAX trainer, its
    optimizer ``tx`` in place of Adam when given."""
    state, vgg_vars = _jax_init()
    system = jstate.MMHandSystem(_config(jcfg, dg_ratio))
    if tx is not None:
        object.__setattr__(system, "tx", tx)
        state = state.replace(opt_g=tx.init(state.g.params),
                              opt_d_pb=tx.init(state.d_pb.params),
                              opt_d_pp=tx.init(state.d_pp.params))
    step = jax.jit(jstep.make_train_step(system, system.make_l1_loss(vgg_vars)))
    return state, step, vgg_vars


def _as_numpy(net):
    return {"params": jax.tree_util.tree_map(np.asarray, net.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, net.batch_stats)}


def _port_dicts(state):
    """The JAX networks as port state_dicts."""
    return {
        "generator": generator_state_dict_from_jax(_as_numpy(state.g),
                                                   use_dropout=False),
        "d_pb": discriminator_state_dict_from_jax(_as_numpy(state.d_pb),
                                                  use_dropout=False),
        "d_pp": discriminator_state_dict_from_jax(_as_numpy(state.d_pp),
                                                  use_dropout=False)}


def _port_side(state, vgg_vars, dg_ratio):
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        system = tstate.build_system(_config(tcfg, dg_ratio), "cpu")
    for name, sd in _port_dicts(state).items():
        getattr(system, name).load_state_dict(sd)
    system.l1_loss.vgg.load_state_dict(
        vgg_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       vgg_vars["params"])))
    return system


def _assert_nets_close(system, state, updates):
    """Every parameter and running statistic of the port against JAX after
    ``updates`` = {net: Adam updates it took} (module docstring)."""
    for name, want in _port_dicts(state).items():
        got = getattr(system, name).state_dict()
        assert set(got) == set(want)
        outside = total = 0
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            a, b = got[k].detach().numpy(), v.numpy()
            diff = np.abs(a - b)
            tol = (1e-5 + 1e-3 * np.abs(b) if "running" in k
                   else 2e-5 + 1e-3 * np.abs(b))
            outside += int((diff > tol).sum())
            total += b.size
            assert diff.max() <= 2 * LR * updates[name], \
                f"{name}.{k} differs by {diff.max()}"
        assert outside <= 0.005 * total, \
            f"{name}: {outside} of {total} elements differ"


@pytest.mark.parametrize("dg_ratio", [1, 2])
def test_train_step_matches_jax_over_three_steps(dg_ratio):
    """Losses every step, then every parameter after three Adam updates and
    every running statistic: G's from its train forwards, the Ds' from their
    own phases only, which shows the G-loss D forwards left them alone."""
    state, step, vgg_vars = _jax_side(dg_ratio)
    system = _port_side(state, vgg_vars, dg_ratio)
    port_step = tstep.make_train_step(system)
    for i in range(3):
        b = _batch(100 + i)
        state, want = step(state, {k: jnp.asarray(v) for k, v in b.items()}, LR)
        got = port_step({k: torch.from_numpy(v) for k, v in b.items()}, LR)
        assert set(got) == LOSS_KEYS
        for key in LOSS_KEYS:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"step {i} loss {key}")
    assert system.step == 3
    _assert_nets_close(system, state, {"generator": 3, "d_pb": 3 * dg_ratio,
                                       "d_pp": 3 * dg_ratio})


def test_step1_gradients_match_jax():
    """Plain descent at lr 1.0 on both sides: each parameter moves by minus
    its gradient, which exposes the step's gradients through its own code
    path (as tests/test_torch_parity.py:433-461)."""
    state, step, vgg_vars = _jax_side(1, optax.sgd(1.0))
    system = _port_side(state, vgg_vars, 1)
    for name in ("g", "d_pb", "d_pp"):
        net = getattr(system, {"g": "generator"}.get(name, name))
        setattr(system, f"opt_{name}", torch.optim.SGD(net.parameters(), lr=1.0))
    before = _port_dicts(state)
    b = _batch(100)
    state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()}, 1.0)
    tstep.make_train_step(system)({k: torch.from_numpy(v)
                                   for k, v in b.items()}, 1.0)
    after = _port_dicts(state)
    for name in before:
        got = getattr(system, name).state_dict()
        for k, v0 in before[name].items():
            if "running" in k or k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(
                (got[k] - v0).numpy(), (after[name][k] - v0).numpy(),
                rtol=1e-3, atol=1e-5, err_msg=f"{name}.{k} gradient")


@pytest.mark.parametrize("policy", ["lambda", "step"])
def test_lr_for_epoch_matches_jax(policy):
    kw = dict(lr_policy=policy, niter=3, niter_decay=4, lr_decay_iters=2)
    for epoch in range(9):
        assert tstep.lr_for_epoch(_config(tcfg, **kw), epoch) == \
            jstep.lr_for_epoch(_config(jcfg, **kw), epoch)


def test_lr_schedule_plateau_matches_jax():
    port = tstep.LRSchedule(_config(tcfg, lr_policy="plateau"))
    want = jstep.LRSchedule(_config(jcfg, lr_policy="plateau"))
    metrics = [None, 5.0, 4.0, 3.99] + [3.98] * 12 + [1.0, 1.0]
    lrs = [port.epoch_lr(e, m) for e, m in enumerate(metrics)]
    assert lrs == [want.epoch_lr(e, m) for e, m in enumerate(metrics)]
    assert min(lrs) < LR  # the plateau cut the rate at least once
    assert port.state_dict() == want.state_dict()
    fresh = tstep.LRSchedule(_config(tcfg, lr_policy="plateau"))
    fresh.load_state_dict(port.state_dict())
    assert fresh.epoch_lr(0, 1.0) == port.epoch_lr(0, 1.0)
    with pytest.raises(NotImplementedError):
        tstep.LRSchedule(_config(tcfg, lr_policy="cosine"))


def test_train_cli_then_aug_on_cpu(tmp_path, capsys):
    """Two toy steps through the CLI write the three networks in the
    reference naming; the port's aug loads the trained generator."""
    ckpt = str(tmp_path / "ckpt")
    argv = ["--dataset", "synthetic", "--fineSize", str(SIZE), "--ngf", "4",
            "--ndf", "4", "--batchSize", "2", "--max_dataset_size", "8",
            "--checkpoints_dir", ckpt, "--name", "run", "--seed", "3"]
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        result = port_train.main(argv + ["--device", "cpu", "--max_steps", "2",
                                         "--print_freq", "1"])
    out = capsys.readouterr().out
    assert result.steps == 2 and set(result.last_metrics) == LOSS_KEYS
    assert all(np.isfinite(v) for v in result.last_metrics.values())
    assert out.count("(epoch: 1, iters: ") == 2
    assert "images/s after the first step" in out
    for net in ("netG", "netD_PB", "netD_PP"):
        assert (tmp_path / "ckpt" / "run" / f"latest_net_{net}.pth").exists()
    written = port_aug.main(argv + ["--dst", str(tmp_path / "fakes"),
                                    "--gen_batch", "4", "--device", "cpu"])
    assert written == 8


def test_unported_options_raise():
    """An unknown init_type raises; the other init types build the system
    (tests/test_torch_zoo.py holds them against mmhand_tpu); the MMHand CSV
    dataset asks for its pair list (tests/test_torch_csv.py runs it).
    fp16 loss scaling and --continue_train are ported:
    tests/test_torch_precision.py and tests/test_torch_resume.py hold
    them."""
    cfg = _config(tcfg)
    for init_type in ("xavier", "kaiming", "orthogonal", "uniform"):
        other = cfg.replace(model=dataclasses.replace(cfg.model,
                                                      init_type=init_type))
        if init_type == "uniform":
            with pytest.raises(NotImplementedError, match=init_type):
                tstate.build_system(other, "cpu")
        else:
            with pytest.warns(UserWarning, match="RANDOM VGG19"):
                tstate.build_system(other, "cpu")
    with pytest.raises(ValueError, match="--pairLst"):
        build_dataset(cfg.replace(data=tcfg.DataConfig(dataset="MMHand")))
    scaled = cfg.replace(precision=tcfg.PrecisionConfig(
        compute_dtype="float32", loss_scaling=True))
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        assert set(tstate.build_system(scaled, "cpu").scales) == {
            "g", "d_pp", "d_pb"}
