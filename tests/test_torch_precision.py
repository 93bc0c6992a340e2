"""mmhand_torch's dynamic loss scaling (train/precision.py and the scaled
train step) against mmhand_tpu's, the twins of tests/test_train.py
TestLossScaling.

The step runs on both sides from the same weights (drawn by JAX, carried
over with mmhand_torch/convert.py) on the same numpy batch, at that test's
configuration: float32, plain L1 (--L1_type origin), pool 0, dropout off.
The tolerances are tests/test_torch_train.py's: losses rtol/atol 2e-4;
parameters after Adam rtol 1e-3, atol 2e-5 (running statistics atol 1e-5) on
all but 0.5% of each network's elements, none more than 2 lr per update
apart.
"""

import functools

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
from mmhand_torch.train import precision as tamp
from mmhand_torch.train import state as tstate
from mmhand_torch.train import step as tstep
from mmhand_tpu import config as jcfg
from mmhand_tpu.train import precision as jamp
from mmhand_tpu.train import state as jstate
from mmhand_tpu.train import step as jstep

B, SIZE, LR = 2, 32, 2e-4
NETS = ("generator", "d_pb", "d_pp")


def _config(module, scaling=True):
    return module.Config(
        model=module.ModelConfig(fine_size=SIZE, g_n_blocks=1, ngf=8, ndf=8,
                                 use_dropout_g=False, use_dropout_d=False),
        loss=module.LossConfig(l1_type="origin"),
        optim=module.OptimConfig(pool_size=0),
        precision=module.PrecisionConfig(compute_dtype="float32",
                                         loss_scaling=scaling))


def _batch(seed=0, h2=None):
    r = np.random.RandomState(seed)
    b = {k: r.uniform(-1, 1, (B, SIZE, SIZE, c)).astype(np.float32)
         for k, c in [("H1", 3), ("H2", 3), ("D1", 3), ("D2", 3),
                      ("P1", 21), ("P2", 21)]}
    if h2 is not None:
        b["H2"] = np.full_like(b["H2"], h2)
    return b


@functools.lru_cache(maxsize=None)
def _jax_side():
    """(initial state, jitted scaled step) of the JAX trainer."""
    system = jstate.MMHandSystem(_config(jcfg))
    state = jax.jit(system.init_state, static_argnames="local_batch_size")(
        jax.random.PRNGKey(0), local_batch_size=B)
    return state, jax.jit(jstep.make_train_step(system, None))


def _numpy(net):
    return {"params": jax.tree_util.tree_map(np.asarray, net.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, net.batch_stats)}


def _port_dicts(state):
    return {"generator": generator_state_dict_from_jax(_numpy(state.g),
                                                       use_dropout=False),
            "d_pb": discriminator_state_dict_from_jax(_numpy(state.d_pb),
                                                      use_dropout=False),
            "d_pp": discriminator_state_dict_from_jax(_numpy(state.d_pp),
                                                      use_dropout=False)}


def _port_side(state, scaling=True):
    system = tstate.build_system(_config(tcfg, scaling), "cpu")
    for name, sd in _port_dicts(state).items():
        getattr(system, name).load_state_dict(sd)
    return system


def _assert_close(got: dict, want: dict, updates: int):
    """tests/test_torch_train.py's per-network bound."""
    for name in NETS:
        outside = total = 0
        for k, v in want[name].items():
            if k.endswith("num_batches_tracked"):
                continue
            a, b = got[name][k].detach().numpy(), v.detach().numpy()
            diff = np.abs(a - b)
            tol = (1e-5 if "running" in k else 2e-5) + 1e-3 * np.abs(b)
            outside += int((diff > tol).sum())
            total += b.size
            assert diff.max() <= 2 * LR * updates, f"{name}.{k} {diff.max()}"
        assert outside <= 0.005 * total, f"{name}: {outside} of {total}"


def _sd(system):
    return {n: {k: v.clone() for k, v in getattr(system, n).state_dict().items()}
            for n in NETS}


def _run_jax(scales=None, batch=None, steps=2):
    state, step = _jax_side()
    if scales is not None:
        state = state.replace(scales=dict(state.scales, **scales))
    metrics = []
    for i in range(steps):
        b = batch or _batch(100 + i)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, LR)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _run_port(system, batch=None, steps=2):
    step = tstep.make_train_step(system)
    metrics = []
    for i in range(steps):
        b = batch or _batch(100 + i)
        m = step({k: torch.from_numpy(v) for k, v in b.items()}, LR)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def _flags(seed):
    """Clean runs that cross the growth interval twice, a burst of
    overflows that reaches the floor at 1, and random flags between."""
    r = np.random.RandomState(seed)
    return ([False] * 2000 + [True] * 20 + list(r.rand(300) < 0.3)
            + [False] * 2001 + [True, False, True])


@pytest.mark.parametrize("init", [4.0, 2.0 ** 16])
def test_update_scale_matches_jax(init):
    port = tamp.init_scale(init)
    want = jamp.init_scale(init)
    update = jax.jit(jamp.update_scale)
    seen = set()
    for flag in _flags(int(init)):
        port = tamp.update_scale(port, torch.tensor(flag))
        want = update(want, jnp.asarray(flag))
        assert float(port.scale) == float(want.scale)
        assert int(port.growth_count) == int(want.growth_count)
        seen.add(float(port.scale))
    assert port.scale.dtype == torch.float32
    assert port.growth_count.dtype == torch.int32
    assert 1.0 in seen and max(seen) > init  # the floor, and growth
    assert tamp.INIT_SCALE == jamp.INIT_SCALE
    assert tamp.GROWTH_INTERVAL == jamp.GROWTH_INTERVAL


@pytest.mark.parametrize("poison", [None, np.inf, -np.inf, np.nan])
def test_overflow_flag_and_unscale_match_jax(poison):
    g = np.random.RandomState(1).normal(0, 1e4, 4096).astype(np.float32)
    if poison is not None:
        g[1234] = poison
    scale = 2.0 ** 13
    port = tamp.unscale_(torch.from_numpy(g.copy()), tamp.init_scale(scale))
    want = jamp.unscale({"w": jnp.asarray(g)}, jamp.init_scale(scale))["w"]
    np.testing.assert_array_equal(port.numpy(), np.asarray(want))
    assert bool(tamp.grads_overflow(port)) == bool(
        jamp.grads_overflow({"w": want})) == (poison is not None)


def test_no_overflow_matches_jax_and_the_unscaled_step():
    """Two clean steps: the port's scaled step against JAX's scaled step,
    and against the port's own unscaled step (the scales are powers of two,
    so only Adam's rounding-decided elements may differ); the scalers count
    two clean steps each and the metrics gain amp_overflow = 0."""
    state, want_metrics = _run_jax()
    scaled = _port_side(_jax_side()[0])
    plain = _port_side(_jax_side()[0], scaling=False)
    got_metrics = _run_port(scaled)
    plain_metrics = _run_port(plain)
    for got, want in zip(got_metrics, want_metrics):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4,
                                       err_msg=k)
        assert got["amp_overflow"] == 0.0
    assert all("amp_overflow" not in m for m in plain_metrics)
    _assert_close(_sd(scaled), _port_dicts(state), 2)
    _assert_close(_sd(scaled), _sd(plain), 2)
    for k in tamp.SCALERS:
        assert float(scaled.scales[k].scale) == 2.0 ** 16
        assert int(scaled.scales[k].growth_count) == 2
        assert float(state.scales[k].scale) == 2.0 ** 16


def test_overflow_skips_all_later_updates():
    """tests/test_train.py test_overflow_skips_all_later_updates in both
    packages: a G scale near the f32 maximum and H2 = 3 (outside tanh's
    range, so pair_L1 ~ 3) put inf in G's scaled gradients.  G, D_PP and
    D_PB all keep their weights and optimizer states, only G's scale backs
    off, amp_overflow is 1, and G's running statistics still move (its
    forward ran)."""
    batch = _batch(0, h2=3.0)
    init, _ = _jax_side()
    out, jm = _run_jax(
        {"g": jamp.LossScaleState(scale=jnp.asarray(3.0e38, jnp.float32),
                                  growth_count=jnp.zeros((), jnp.int32))},
        batch, steps=1)
    system = _port_side(init)
    system.scales["g"] = tamp.init_scale(3.0e38)
    before = _sd(system)
    [pm] = _run_port(system, batch, steps=1)

    assert pm["amp_overflow"] == jm[0]["amp_overflow"] == 1.0
    for k in ("pair_L1loss", "pair_GANloss", "D_PP", "D_PB"):
        np.testing.assert_allclose(pm[k], jm[0][k], rtol=2e-4, atol=2e-4)
    after = _sd(system)
    for name in NETS:
        for k, v in before[name].items():
            if "running" in k or k.endswith("num_batches_tracked"):
                continue
            assert torch.equal(after[name][k], v), f"{name}.{k} moved"
    for opt in (system.opt_g, system.opt_d_pp, system.opt_d_pb):
        assert not opt.state  # no Adam step was taken
    stats = [k for k in before["generator"] if "running" in k]
    assert stats and not all(torch.equal(after["generator"][k],
                                         before["generator"][k]) for k in stats)
    for a, b in zip(jax.tree.leaves((init.g.params, init.d_pb.params,
                                     init.d_pp.params, init.opt_g)),
                    jax.tree.leaves((out.g.params, out.d_pb.params,
                                     out.d_pp.params, out.opt_g))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for scales in (system.scales, out.scales):
        assert float(scales["g"].scale) == pytest.approx(1.5e38)
        assert int(scales["g"].growth_count) == 0
        for k in ("d_pp", "d_pb"):
            assert float(scales[k].scale) == 2.0 ** 16
            assert int(scales[k].growth_count) == 1


def test_fp16_system_trains_on_the_cpu():
    """float16 autocast with loss scaling: pools in f16, three scalers at
    2^16, two finite steps, every parameter finite."""
    cfg = _config(tcfg).replace(
        precision=tcfg.PrecisionConfig(compute_dtype="float16",
                                       loss_scaling=True),
        optim=tcfg.OptimConfig(pool_size=2))
    system = tstate.build_system(cfg, "cpu")
    assert system.pool_pb.images.dtype == torch.float16
    assert set(system.scales) == {"g", "d_pp", "d_pb"}
    metrics = _run_port(system)
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    assert system.step == 2
    for name in NETS:
        for v in getattr(system, name).state_dict().values():
            assert torch.isfinite(v.float()).all()
