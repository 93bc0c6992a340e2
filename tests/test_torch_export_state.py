"""tools/export_jax_state.py: train states that mmhand_tpu saved (orbax),
exported to the port's ``state_<label>.pt`` and restored by the port's
``CheckpointManager``.

Each case takes mmhand_tpu's state after two JAX steps (the Adam moments,
the count, the pools and the scales are then all non-trivial), saves it
with mmhand_tpu's ``CheckpointManager``, exports it and restores it in the
port.  Every network tensor, Adam moment, step, pool row and scale then
equals its JAX leaf under the mapping (float32, exactly), and one more
step of the port matches JAX's next step: the losses at rtol/atol 2e-4,
every parameter within tests/test_torch_train.py's bound (at most 0.5% of
a network's elements outside 2e-5 + 1e-3 |x|, none more than 2 lr away),
and the Adam moments after it within 1e-2 of their norm over each network
(a moment that did not carry over would be off by half its norm).  The
random streams do not carry over, so the steps run with dropout off and
with pools that are not yet full (a pool then hands back the new fakes and
draws nothing).  The cases: the GAN with pools and loss scaling, the GAN
from a 2-device mesh (its per-replica pools become the port's rank rows;
the next step runs as two gloo ranks), HPE ``hpm`` (both nets) and hand3d
``lifting``.
"""

import dataclasses
import functools
import importlib.util
import shutil
import warnings
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch import config as tcfg
from mmhand_torch.convert import (
    cpm_state_dict_from_jax,
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    hand3d_state_dict_from_jax,
)
from mmhand_torch.hand3d import system as th3d
from mmhand_torch.hpe import system as thpe
from mmhand_torch.models import hand3d as tnet
from mmhand_torch.parallel.dryrun import launch
from mmhand_torch.train import step as tstep
from mmhand_torch.train.loop import train
from mmhand_torch.train.state import build_system
from mmhand_torch.utils.checkpoint import CheckpointManager
from mmhand_tpu import config as jcfg
from mmhand_tpu.hand3d import system as jh3d
from mmhand_tpu.hpe import system as jhpe
from mmhand_tpu.models import cpm as jcpm
from mmhand_tpu.parallel import (
    make_mesh,
    make_sharded_train_step,
    replicate_state_for_mesh,
    shard_batch,
)
from mmhand_tpu.train import precision as jamp
from mmhand_tpu.train import state as jstate
from mmhand_tpu.train import step as jstep
from mmhand_tpu.utils.checkpoint import CheckpointManager as JaxCheckpoints
from test_torch_threads import two_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "export_jax_state", REPO / "tools" / "export_jax_state.py")
ex = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ex)

SIZE, B, POOL, LR = 32, 2, 6, 2e-4
NETS = ("generator", "d_pb", "d_pp")
OPTS = {"generator": "opt_g", "d_pb": "opt_d_pb", "d_pp": "opt_d_pp"}


def _gan_config(module, tmp, name, scaling=False):
    return module.Config(
        model=module.ModelConfig(fine_size=SIZE, g_n_blocks=1, n_layers_d=1,
                                 ngf=8, ndf=8, use_dropout_g=False,
                                 use_dropout_d=False),
        loss=module.LossConfig(l1_type="origin"),
        optim=module.OptimConfig(pool_size=POOL),
        data=module.DataConfig(dataset="synthetic", batch_size=B),
        precision=module.PrecisionConfig(compute_dtype="float32",
                                         loss_scaling=scaling),
        run=module.RunConfig(checkpoints_dir=str(tmp), name=name))


def _gan_batch(seed, n=B):
    r = np.random.RandomState(seed)
    return {k: r.uniform(-1, 1, (n, SIZE, SIZE, c)).astype(np.float32)
            for k, c in [("H1", 3), ("H2", 3), ("D1", 3), ("D2", 3),
                         ("P1", 21), ("P2", 21)]}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_gan_nets(state):
    """{net: (port state_dict, (mu, nu) as port dicts, count)} of a JAX
    GAN state (dropout off)."""
    gen = functools.partial(generator_state_dict_from_jax, use_dropout=False)
    disc = functools.partial(discriminator_state_dict_from_jax,
                             use_dropout=False)
    out = {}
    for name, field, to_sd in (("generator", "g", gen), ("d_pb", "d_pb", disc),
                               ("d_pp", "d_pp", disc)):
        net = getattr(state, field)
        stats = _np(net.batch_stats)
        adam = getattr(state, OPTS[name])[0]
        conv = lambda t: to_sd({"params": _np(t), "batch_stats": stats})  # noqa: E731
        out[name] = (conv(net.params), (conv(adam.mu), conv(adam.nu)),
                     int(adam.count))
    return out


def _assert_equal_state(nets: dict, opts: dict, want: dict):
    """Nets and Adams of the port against JAX's, exactly; each moment sits
    on the parameter of its name in ``net.parameters()`` order."""
    for name, net in nets.items():
        sd, (mu, nu), count = want[name]
        got = net.state_dict()
        for k, v in sd.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(got[k], v), f"{name}.{k}"
        opt = opts[name]
        params = dict(net.named_parameters())
        assert len(opt.state) == len(params) > 0
        for k, p in params.items():
            st = opt.state[p]
            assert float(st["step"]) == count
            assert torch.equal(st["exp_avg"], mu[k]), f"{name}.{k} mu"
            assert torch.equal(st["exp_avg_sq"], nu[k]), f"{name}.{k} nu"


def _assert_nets_close(got: dict, want: dict, updates: int = 1):
    """tests/test_torch_train.py's per-network bound."""
    outside = total = 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        a, b = got[k].detach().float().numpy(), v.numpy()
        diff = np.abs(a - b)
        tol = (1e-5 if "running" in k else 2e-5) + 1e-3 * np.abs(b)
        outside += int((diff > tol).sum())
        total += b.size
        assert diff.max() <= 2 * LR * updates, f"{k} differs by {diff.max()}"
    assert outside <= 0.005 * total, f"{outside} of {total} elements differ"


def _assert_moments_close(net, opt, mu: dict, nu: dict, what: str):
    """The Adam moments after the next step, over the whole network, within
    1e-2 of their norm (f32 gradients from two frameworks)."""
    for key, want in (("exp_avg", mu), ("exp_avg_sq", nu)):
        num = den = 0.0
        for k, p in net.named_parameters():
            a = opt.state[p][key].double()
            b = want[k].double()
            num += float(((a - b) ** 2).sum())
            den += float((b ** 2).sum())
        assert num <= 1e-4 * den, f"{what} {key}: {num ** .5} of {den ** .5}"


# --------------------------------------------------------------- the GAN

@functools.lru_cache(maxsize=None)
def _jax_gan(tmp: str):
    """mmhand_tpu's GAN state after two steps (pools of 6 holding 4 fakes,
    distinct loss scales) saved under ``tmp``, its jitted step and the
    state after a third step."""
    cfg = _gan_config(jcfg, tmp, "gan", scaling=True)
    system = jstate.MMHandSystem(cfg)
    state = jax.jit(system.init_state, static_argnames="local_batch_size")(
        jax.random.PRNGKey(0), local_batch_size=B)
    state = state.replace(scales=dict(
        state.scales, d_pp=jamp.init_scale(2.0 ** 14),
        d_pb=jamp.init_scale(2.0 ** 15)))
    step = jax.jit(jstep.make_train_step(system, None))
    for i in range(2):
        state, _ = step(state, {k: jnp.asarray(v)
                                for k, v in _gan_batch(100 + i).items()}, LR)
    JaxCheckpoints(tmp, "gan").save(state)
    after, metrics = step(state, {k: jnp.asarray(v)
                                  for k, v in _gan_batch(102).items()}, LR)
    return cfg, jax.device_get(state), jax.device_get(after), metrics


@pytest.fixture(scope="module")
def gan_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("gan")
    yield str(path)
    shutil.rmtree(path, ignore_errors=True)


def _port_gan(cfg, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_system(ex.port_config(cfg), "cpu", **kw)


def test_gan_state_exports_and_steps_on(gan_dir):
    cfg, state, after, want = _jax_gan(gan_dir)
    summary = ex.export_gan(cfg)
    assert summary == {"kind": "gan", "label": "latest", "step": 2,
                       "world": 1, "rng": "fresh",
                       "path": str(Path(gan_dir) / "gan" / "state_latest.pt")}
    system = _port_gan(cfg)
    assert CheckpointManager(gan_dir, "gan").restore(system) is True
    assert system.step == 2
    _assert_equal_state({n: getattr(system, n) for n in NETS},
                        {n: getattr(system, OPTS[n]) for n in NETS},
                        _jax_gan_nets(state))
    for name in ("pool_pb", "pool_pp"):
        pool, jpool = getattr(system, name), getattr(state, name)
        assert pool.num == int(jpool.num) == 4
        assert pool.images.dtype == torch.float32
        assert torch.equal(pool.images, torch.from_numpy(
            np.array(jpool.images)))
    for k, s in state.scales.items():
        assert float(system.scales[k].scale) == float(s.scale)
        assert int(system.scales[k].growth_count) == int(s.growth_count) == 2
    assert {k: float(s.scale) for k, s in system.scales.items()} == {
        "g": 2.0 ** 16, "d_pp": 2.0 ** 14, "d_pb": 2.0 ** 15}

    got = tstep.make_train_step(system)(
        {k: torch.from_numpy(v) for k, v in _gan_batch(102).items()}, LR)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4,
                                   atol=2e-4, err_msg=k)
    assert system.step == 3
    jnets = _jax_gan_nets(after)
    for name in NETS:
        sd, (mu, nu), count = jnets[name]
        assert count == 3
        _assert_nets_close(getattr(system, name).state_dict(), sd)
        _assert_moments_close(getattr(system, name), getattr(system, OPTS[name]),
                              mu, nu, name)
    for name in ("pool_pb", "pool_pp"):  # 2 more fakes, no swap drawn
        pool, jpool, before = (getattr(system, name), getattr(after, name),
                               getattr(state, name))
        assert pool.num == int(jpool.num) == 6
        assert torch.equal(pool.images[:4],
                           torch.from_numpy(np.array(before.images)[:4]))
        np.testing.assert_allclose(pool.images[4:].numpy(),
                                   np.asarray(jpool.images)[4:], atol=1e-4)
    for k, s in after.scales.items():
        assert float(system.scales[k].scale) == float(s.scale)
        assert int(system.scales[k].growth_count) == int(s.growth_count) == 3


def test_trainer_resumes_an_exported_state(gan_dir, capsys):
    """``train(--continue_train)`` restores the exported file, says that
    its random streams start fresh, and steps on from step 2."""
    cfg = _jax_gan(gan_dir)[0]
    ex.export_gan(cfg)
    pcfg = ex.port_config(cfg)
    pcfg = dataclasses.replace(pcfg, run=dataclasses.replace(
        pcfg.run, continue_train=True, print_freq=1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = train(pcfg, device="cpu", max_steps=1)
    out = capsys.readouterr().out
    assert ("resumed at step 2 from a state mmhand_tpu trained: the pool "
            "and dropout streams start fresh from --seed 49") in out
    assert result.steps == 1 and result.system.step == 3
    assert CheckpointManager(gan_dir, "gan").restore(
        _port_gan(cfg)) is False  # the file it saved holds its streams


def test_gan_pools_keep_the_compute_dtype(tmp_path):
    """A float16 run's pools stay float16, bit for bit, and a state with no
    loss scaling exports None; from mmhand_tpu's own template."""
    cfg = _gan_config(jcfg, tmp_path, "f16")
    cfg = cfg.replace(precision=jcfg.PrecisionConfig(compute_dtype="float16"))
    state = ex.gan_template(cfg)
    rng = np.random.RandomState(5)
    pools = {}
    for name in ("pool_pb", "pool_pp"):
        images = rng.uniform(-1, 1, getattr(state, name).images.shape)
        pools[name] = images.astype(np.float16)
        state = state.replace(**{name: getattr(state, name)._replace(
            images=pools[name], num=np.asarray(3, np.int32))})
    JaxCheckpoints(str(tmp_path), "f16").save(state)
    assert ex.export_gan(cfg)["step"] == 0
    saved = torch.load(tmp_path / "f16" / "state_latest.pt", weights_only=True)
    assert saved["scales"] is None and saved["rng"] == "fresh"
    for name, images in pools.items():
        rows = saved["rank"][name]
        assert rows.dtype == torch.float16 and rows.shape == (1, *images.shape)
        assert torch.equal(rows[0], torch.from_numpy(images))
        assert saved["rank"][f"{name}_num"].tolist() == [3]
    system = _port_gan(cfg)
    CheckpointManager(str(tmp_path), "f16").restore(system)
    assert system.pool_pb.images.dtype == torch.float16


_MESH_WORKER = r'''
import sys
import warnings
import torch
import torch.distributed as dist
from mmhand_torch import config as tcfg
from mmhand_torch.parallel import init_distributed
from mmhand_torch.train.state import build_system
from mmhand_torch.train.step import make_train_step
from mmhand_torch.utils.checkpoint import CheckpointManager

tmp = sys.argv[1]
init_distributed("cpu")
rank = dist.get_rank()
cfg = tcfg.Config(
    model=tcfg.ModelConfig(fine_size=32, g_n_blocks=1, n_layers_d=1, ngf=8,
                           ndf=8, use_dropout_g=False, use_dropout_d=False),
    loss=tcfg.LossConfig(l1_type="origin"),
    optim=tcfg.OptimConfig(pool_size=6),
    precision=tcfg.PrecisionConfig(compute_dtype="float32"))
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    s = build_system(cfg, "cpu", distributed=True)
fresh = CheckpointManager(tmp, "mesh").restore(s)
out = {"fresh": fresh, "step": s.step,
       "pools": {n: (getattr(s, n).images.clone(), getattr(s, n).num)
                 for n in ("pool_pb", "pool_pp")}}
batch = torch.load(f"{tmp}/batch.pt")
m = make_train_step(s)({k: v[2 * rank:2 * rank + 2] for k, v in batch.items()},
                       2e-4)
out.update(metrics={k: float(v) for k, v in m.items()},
           nets={n: getattr(s, n).state_dict() for n in ("generator", "d_pb",
                                                         "d_pp")},
           opts={n: getattr(s, n).state_dict() for n in ("opt_g", "opt_d_pb",
                                                         "opt_d_pp")},
           after={n: (getattr(s, n).images, getattr(s, n).num)
                  for n in ("pool_pb", "pool_pp")})
torch.save(out, f"{tmp}/out{rank}.pt")
dist.destroy_process_group()
'''


def test_mesh_state_exports_per_replica_rows(tmp_path):
    """A state from mmhand_tpu's 2-device mesh (2 items a replica) exported
    with world 2: the (2, ...) rank rows are the replicas' pools; two gloo
    ranks restore it, each its own row, and their DP step matches the
    mesh's next step."""
    cfg = _gan_config(jcfg, tmp_path, "mesh")
    mesh = make_mesh(2)
    system = jstate.MMHandSystem(cfg, axis_name="data")
    state = jax.jit(system.init_state, static_argnames="local_batch_size")(
        jax.random.PRNGKey(0), local_batch_size=B)
    state = replicate_state_for_mesh(state, mesh)
    step = make_sharded_train_step(system, None, mesh)
    batches = [_gan_batch(200 + i, 2 * B) for i in range(3)]
    for b in batches[:2]:
        state, _ = step(state, shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}, mesh), LR)
    host = jax.device_get(state)
    JaxCheckpoints(str(tmp_path), "mesh").save(state)
    with pytest.raises(ValueError, match="2 replicas"):
        ex.export_gan(cfg, world=1)
    assert ex.export_gan(cfg, world=2)["world"] == 2
    saved = torch.load(tmp_path / "mesh" / "state_latest.pt",
                       weights_only=True)
    for name in ("pool_pb", "pool_pp"):
        jpool = getattr(host, name)
        assert saved["rank"][name].shape == (2, POOL, SIZE, SIZE,
                                             jpool.images.shape[-1])
        assert torch.equal(saved["rank"][name],
                           torch.from_numpy(np.array(jpool.images)))
        assert saved["rank"][f"{name}_num"].tolist() == [4, 4]
    with pytest.raises(ValueError, match="saved by 2 ranks"):
        CheckpointManager(str(tmp_path), "mesh").restore(_port_gan(cfg))

    after, want = step(state, shard_batch(
        {k: jnp.asarray(v) for k, v in batches[2].items()}, mesh), LR)
    after = jax.device_get(after)
    torch.save({k: torch.from_numpy(v) for k, v in batches[2].items()},
               tmp_path / "batch.pt")
    worker = tmp_path / "worker.py"
    worker.write_text(_MESH_WORKER)
    launch([str(worker), str(tmp_path)], 2, timeout=120,
           env={"OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)})
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(2)]
    jnets = _jax_gan_nets(after)
    for r, o in enumerate(outs):
        assert o["fresh"] is True and o["step"] == 2
        for name, (images, num) in o["pools"].items():
            assert num == 4
            assert torch.equal(images, torch.from_numpy(
                np.array(getattr(host, name).images)[r]))
        for name, (images, num) in o["after"].items():
            assert num == 6
            np.testing.assert_allclose(
                images.numpy(), np.asarray(getattr(after, name).images)[r],
                atol=1e-4)
        for k, v in want.items():
            np.testing.assert_allclose(o["metrics"][k], float(v), rtol=2e-4,
                                       atol=2e-4, err_msg=k)
        for name in NETS:
            _assert_nets_close(o["nets"][name], jnets[name][0])
    for name in NETS:  # the same nets and moments on both ranks
        for k, v in outs[0]["nets"][name].items():
            assert torch.equal(v, outs[1]["nets"][name][k])
    net = _port_gan(cfg).generator
    opt = torch.optim.Adam(net.parameters())
    opt.load_state_dict(outs[0]["opts"]["opt_g"])
    _assert_moments_close(net, opt, *jnets["generator"][1], "mesh generator")


# ------------------------------------------------------------------- HPE

def _hpe_batch(seed):
    rng = np.random.RandomState(seed)
    return {"image": rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
            "heatmaps": rng.uniform(0, 1, (B, SIZE, SIZE, 21)).astype(
                np.float32),
            "z": rng.uniform(0, 1.4, (B, 21)).astype(np.float32),
            "weight": np.ones(B, np.int32)}


def test_hpe_state_exports_and_steps_on(tmp_path):
    """``hpm``: Hpm2d and Hpm3d with their Adams from two JAX steps; the
    port's drawn weights start both sides (faster than flax's init)."""
    cfg = jcfg.Config(model=jcfg.ModelConfig(fine_size=SIZE),
                      run=jcfg.RunConfig(checkpoints_dir=str(tmp_path),
                                         name="hpe"))
    pcfg = ex.port_config(cfg).replace(
        precision=tcfg.PrecisionConfig(compute_dtype="float32"))
    port = thpe.HPESystem(pcfg, "hpm", "cpu")
    jsystem = jhpe.HPESystem(dtype=jnp.float32, variant="hpm")
    p2d, p3d = (jcpm.load_cpm_state_dict(
        {k: v.detach().clone() for k, v in getattr(port, n).state_dict()
         .items()})["params"] for n in ("hpm2d", "hpm3d"))
    state = jhpe.HPETrainState(
        step=jnp.zeros((), jnp.int32), params2d=p2d, params3d=p3d,
        opt2d=jsystem.tx.init(p2d), opt3d=jsystem.tx.init(p3d))
    step = jax.jit(jhpe.make_hpe_train_step(jsystem))
    for i in range(2):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in
                                _hpe_batch(10 + i).items()}, LR)
    JaxCheckpoints(str(tmp_path), "hpe").save(state)
    after, want = step(state, {k: jnp.asarray(v) for k, v in
                               _hpe_batch(12).items()}, LR)
    state, after = jax.device_get(state), jax.device_get(after)

    assert ex.export_hpe(cfg, "hpm")["step"] == 2
    CheckpointManager(str(tmp_path), "hpe").restore(port)
    assert port.step == 2
    conv = lambda t: cpm_state_dict_from_jax({"params": t})  # noqa: E731
    expected = {name: (conv(params), (conv(opt[0].mu), conv(opt[0].nu)),
                       int(opt[0].count))
                for name, params, opt in (
                    ("hpm2d", state.params2d, state.opt2d),
                    ("hpm3d", state.params3d, state.opt3d))}
    _assert_equal_state({"hpm2d": port.hpm2d, "hpm3d": port.hpm3d},
                        {"hpm2d": port.opt2d, "hpm3d": port.opt3d}, expected)
    # a moment of a conv kernel is its HWIO leaf as OIHW
    mu = np.asarray(state.opt2d[0].mu["conv6_1_CPM"]["Conv_0"]["kernel"])
    weight = dict(port.hpm2d.named_parameters())["conv6_1_CPM.weight"]
    assert torch.equal(port.opt2d.state[weight]["exp_avg"],
                       torch.from_numpy(np.transpose(mu, (3, 2, 0, 1)).copy()))

    got = thpe.make_hpe_train_step(port)(
        {k: torch.from_numpy(v) for k, v in _hpe_batch(12).items()}, LR)
    assert set(got) == set(want) == {"mse", "lz"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4,
                                   err_msg=k)
    for name, params, opt in (("hpm2d", after.params2d, after.opt2d),
                              ("hpm3d", after.params3d, after.opt3d)):
        _assert_nets_close(getattr(port, name).state_dict(), conv(params))
        _assert_moments_close(getattr(port, name),
                              getattr(port, {"hpm2d": "opt2d",
                                             "hpm3d": "opt3d"}[name]),
                              conv(opt[0].mu), conv(opt[0].nu), name)


# ---------------------------------------------------------------- hand3d

class _NoDropout(fnn.Module):
    """flax's Dropout with nothing dropped."""

    rate: float
    deterministic: bool = None

    def __call__(self, x):
        return x


def _lifting_batch(seed):
    rng = np.random.RandomState(seed)
    return {"scoremap": rng.uniform(0, 1, (B, SIZE, SIZE, 21)).astype(
                np.float32),
            "hand_side": np.tile(np.array([[1.0, 0.0]], np.float32), (B, 1)),
            "keypoint_xyz21_can": rng.normal(size=(B, 21, 3)).astype(
                np.float32),
            "rot_mat": np.tile(np.eye(3, dtype=np.float32)[None], (B, 1, 1))}


def test_hand3d_state_exports_and_steps_on(tmp_path, monkeypatch):
    """``lifting`` (proposed) from two JAX steps, dropout off on both
    sides; the port's trainer would resume it at step 2."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(tnet, "dropout", lambda x, *args: x)
    jsystem = jh3d.Hand3DSystem(net="lifting", variant="proposed",
                                crop_size=SIZE)
    state = jax.jit(jsystem.init_state, static_argnums=1)(
        jax.random.PRNGKey(0), (SIZE, SIZE))
    step = jax.jit(jsystem.make_train_step())
    for i in range(2):
        state, _ = step(state, {k: jnp.asarray(v)
                                for k, v in _lifting_batch(20 + i).items()})
    JaxCheckpoints(str(tmp_path), "h3d_lifting").save(state)
    after, want = step(state, {k: jnp.asarray(v)
                               for k, v in _lifting_batch(22).items()})
    state, after = jax.device_get(state), jax.device_get(after)

    summary = ex.export_hand3d(str(tmp_path), "h3d", "lifting",
                               image_size=SIZE, crop_size=SIZE)
    assert summary["step"] == 2 and summary["rng"] == "fresh"
    port = th3d.Hand3DSystem("lifting", "proposed", crop_size=SIZE,
                             device="cpu", seed=3)
    port.dropout_gen.manual_seed(99)
    assert CheckpointManager(str(tmp_path), "h3d_lifting").restore(port)
    assert port.step == 2
    # the dropout stream restarts from the run's seed
    assert torch.equal(port.dropout_gen.get_state(), torch.Generator()
                       .manual_seed(3).get_state())
    conv = hand3d_state_dict_from_jax
    _assert_equal_state({"lifting": port.module}, {"lifting": port.opt},
                        {"lifting": (conv(state.params),
                                     (conv(state.opt[0].mu),
                                      conv(state.opt[0].nu)),
                                     int(state.opt[0].count))})
    got = th3d.make_hand3d_train_step(port)(
        {k: torch.from_numpy(v) for k, v in _lifting_batch(22).items()})
    np.testing.assert_allclose(float(got), float(want), rtol=2e-4)
    lr = jsystem.train_para["lr"][0]
    want_sd = conv(after.params)
    outside = total = 0
    for k, v in want_sd.items():
        diff = np.abs(port.module.state_dict()[k].numpy() - v.numpy())
        outside += int((diff > 2e-5 + 1e-3 * np.abs(v.numpy())).sum())
        total += v.numel()
        assert diff.max() <= 2 * lr, k
    assert outside <= 0.005 * total
    _assert_moments_close(port.module, port.opt, conv(after.opt[0].mu),
                          conv(after.opt[0].nu), "lifting")
