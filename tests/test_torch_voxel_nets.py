"""The depth and voxel GAN nets of the port against mmhand_tpu's, and the
5-D BatchNorm moments they run on.

mmhand_tpu's random init, with drawn BatchNorm scales, biases and running
statistics, goes to the port through ``convert.*_from_jax``.  Both packages
run in float32 on the CPU: VoxelGenerator and VoxelDiscriminator at 16^3 and
batch 2, DepthGenerator at batch 2, DepthDiscriminator at 256 px with ndf 8.
Each is held in eval mode and over one train-mode forward (batch
statistics), its outputs within 1e-4 of their largest value, and the
running statistics that forward leaves within 1e-5.  The port's
``state_dict()`` goes back through mmhand_tpu's ``load_*_state_dict``, which
reads the reference's torch keys, and gives the same variables.  One JAX jit
per net does both modes.
"""

import contextlib
import copy
import functools

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mmhand_torch import convert
from mmhand_torch.models import voxel_nets as tnets
from mmhand_torch.models.layers import BatchNorm3d
from mmhand_torch.ops.bn_stats import bn_moments, rows_view
from mmhand_tpu.models import voxel_nets as jnets
from test_torch_threads import two_threads  # noqa: F401


# name: (mmhand_tpu net, port net, to port, mmhand_tpu loader, input shape,
# number of BatchNorms)
CASES = {
    "voxel_generator": (
        jnets.VoxelGenerator(), tnets.VoxelGenerator,
        convert.voxel_generator_state_dict_from_jax,
        jnets.load_voxel_generator_state_dict, (2, 16, 16, 16, 1), 31),
    "voxel_discriminator": (
        jnets.VoxelDiscriminator(), tnets.VoxelDiscriminator,
        convert.voxel_discriminator_state_dict_from_jax,
        jnets.load_voxel_discriminator_state_dict, (2, 16, 16, 16, 2), 4),
    "depth_generator": (
        jnets.DepthGenerator(), tnets.DepthGenerator,
        convert.depth_generator_state_dict_from_jax,
        jnets.load_depth_generator_state_dict, (2, 42), 5),
    "depth_discriminator": (
        jnets.DepthDiscriminator(ndf=8), functools.partial(
            tnets.DepthDiscriminator, ndf=8),
        convert.depth_discriminator_state_dict_from_jax,
        jnets.load_depth_discriminator_state_dict, (2, 256, 256, 1), 3),
}


def _drawn(tree, seed):
    """BatchNorm scales, biases and running statistics drawn away from
    their init, so that the maps of each are seen."""
    rng = np.random.RandomState(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf == "var":
            return rng.uniform(0.1, 1.0, a.shape).astype(np.float32)
        if leaf in ("mean", "bias"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if leaf == "scale":
            return rng.normal(1, 0.1, a.shape).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(draw, tree)


@functools.lru_cache(maxsize=None)
def _case(name):
    jax_net, _, _, _, shape, _ = CASES[name]
    rng = np.random.RandomState(len(name))
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    v = jax.jit(lambda r: jax_net.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(0))
    variables = {"params": _drawn(v["params"], 1),
                 "batch_stats": _drawn(v["batch_stats"], 2)}

    @jax.jit
    def both(v, inputs):
        evald = jax_net.apply(v, inputs, train=False)
        trained, upd = jax_net.apply(v, inputs, train=True,
                                     mutable=["batch_stats"])
        return evald, trained, upd["batch_stats"]

    return variables, x, both(variables, x)


def _port(name, variables):
    _, make, to_port, _, _, _ = CASES[name]
    net = make()
    sd = to_port(variables)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    return net


def _outputs(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def _hold(got, want, what):
    for g, w in zip(_outputs(got), _outputs(want)):
        assert g.shape == w.shape, what
        scale = float(np.abs(w).max())
        assert scale > 1e-3, what  # a real signal
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
    """Eval mode, then one train-mode forward: its outputs and the running
    statistics it leaves."""
    variables, x, (want_eval, want_train, new_stats) = _case(name)
    net = _port(name, variables)
    n_jax = sum(a.size for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in net.parameters()) == n_jax
    net.eval()
    with torch.no_grad():
        _hold(net(torch.from_numpy(x)), want_eval, f"{name} eval")
    net.train()
    with torch.no_grad():
        _hold(net(torch.from_numpy(x)), want_train, f"{name} train")
    want_sd = CASES[name][2]({"params": variables["params"],
                              "batch_stats": new_stats})
    stats = 0
    for key, value in net.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), want_sd[key].numpy(),
                                       rtol=0, atol=1e-5, err_msg=key)
            stats += 1
    assert stats == 2 * CASES[name][5]


@pytest.mark.parametrize("name", list(CASES))
def test_state_dict_reads_back_through_jax_loader(name):
    """The port's keys are the reference's: mmhand_tpu's loader turns the
    port's state_dict into the variables it came from."""
    variables, _, _ = _case(name)
    net = _port(name, variables)
    # copies: mmhand_tpu's loader keeps numpy views, which jax may alias
    back = CASES[name][3]({k: v.numpy().copy()
                           for k, v in net.state_dict().items()})
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(flat_want[path]),
                                      err_msg=jax.tree_util.keystr(path))


def test_reference_keys_and_sizes():
    """Key names of the reference layouts, the BatchNorms, and the nets'
    parameter counts at their default widths (3.41 M, 1.13 M, 0.17 M and
    16.81 M, as mmhand_tpu's)."""
    for name, (_, make, _, _, _, n_bn) in CASES.items():
        net = make()
        keys = set(net.state_dict())
        assert sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                   for m in net.modules()) == n_bn
        if name == "voxel_generator":
            assert {"front_layers.0.block.0.weight",
                    "front_layers.2.skip_con.1.running_var",
                    "encoder_decoder.skip_res1.res_branch.0.weight",
                    "encoder_decoder.decoder_upsample2.block.0.weight",
                    "back_layers.3.block.1.running_mean",
                    "output_layer.bias"} <= keys
        elif name == "voxel_discriminator":
            assert {"models.models.0.weight", "models.models.10.running_var",
                    } <= keys
        elif name == "depth_discriminator":
            assert {"encoder.0.bias", "predictor.2.weight",
                    "hard_predictor.5.weight", "hard_predictor.6.bias",
                    "classifier.weight"} <= keys
    counts = {cls.__name__: sum(p.numel() for p in cls().parameters())
              for cls in (tnets.VoxelGenerator, tnets.VoxelDiscriminator,
                          tnets.DepthGenerator, tnets.DepthDiscriminator)}
    assert counts == {"VoxelGenerator": 3_410_047,
                      "VoxelDiscriminator": 1_126_658,
                      "DepthGenerator": 171_011,
                      "DepthDiscriminator": 16_805_227}
    assert tnets.DepthDiscriminator().hard_predictor[5].in_features == 65536


def test_depth_discriminator_refuses_128_px():
    net = tnets.DepthDiscriminator(ndf=8)
    with pytest.raises(ValueError, match="256x256"):
        net(torch.zeros(1, 128, 128, 1))


@pytest.mark.parametrize("channels", [1, 5])
def test_bn_moments_5d_match_flax(channels):
    """The 5-D moments of ``bn_moments`` give flax ``nn.BatchNorm``'s batch
    statistics (its fast variance), and ``BatchNorm3d`` its output and its
    biased running variance."""
    rng = np.random.RandomState(channels)
    x = (rng.normal(0.3, 1.5, (2, 3, 4, 5, channels))).astype(np.float32)
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), x, use_running_average=False)
    want, upd = bn.apply(v, x, use_running_average=False,
                         mutable=["batch_stats"])
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    assert xt.is_contiguous(memory_format=torch.channels_last_3d)
    mean, mean_sq = bn_moments(xt)
    np.testing.assert_allclose(mean.numpy(), x.mean(axis=(0, 1, 2, 3)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mean_sq.numpy(),
                               (x.astype(np.float64) ** 2).mean(
                                   axis=(0, 1, 2, 3)), rtol=1e-5)
    port = BatchNorm3d(channels).train()
    got = port(xt).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=0, atol=1e-6)


def test_rows_view_takes_channels_last_3d_only():
    x = torch.zeros(2, 3, 4, 5, 6)
    with pytest.raises(ValueError, match="channels_last"):
        rows_view(x)
    assert rows_view(x.contiguous(memory_format=torch.channels_last_3d)) \
        == (2 * 4 * 5 * 6, 3)
    with pytest.raises(ValueError, match="5-D"):
        rows_view(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError):
        rows_view(x.double().contiguous(
            memory_format=torch.channels_last_3d))


@pytest.mark.parametrize("name", ["VoxelGenerator", "VoxelDiscriminator",
                                  "DepthGenerator"])
def test_kink_decisions_replay(name):
    """``kink_decisions``, with which the card tests hold these nets'
    gradients: recording leaves a pass as it was; a net replaying the
    decisions it recorded gives its own outputs bit for bit and its
    gradients within 1e-5 of their norm (``gradient_errors``: the replayed
    ops' backward passes sum in another order), and no decision differs
    from its own; a copy whose weights moved replays the first's decisions
    and counts the ones it makes apart and how far from their kink they
    lie."""
    from mmhand_torch.models.check_nets import gradient_errors, kink_decisions

    shape = {"VoxelGenerator": (2, 16, 16, 16, 1),
             "VoxelDiscriminator": (2, 16, 16, 16, 2),
             "DepthGenerator": (2, 42)}[name]
    torch.manual_seed(0)
    net = getattr(tnets, name)().train()
    twin = copy.deepcopy(net)
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, shape).astype(np.float32))

    def run(model, **kwargs):
        model.zero_grad()
        with (kink_decisions(**kwargs) if kwargs
              else contextlib.nullcontext()):
            out = model(x)
        out.square().sum().backward()
        return out.detach(), [p.grad.clone() for p in model.parameters()]

    decisions, margins = [], []
    out, grads = run(net, record=decisions)
    want_out, want_grads = run(twin)
    assert torch.equal(out, want_out)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    replay = iter(decisions)
    got_out, _ = run(twin, replay=replay, margins=margins)
    assert next(replay, None) is None and len(margins) == len(decisions)
    assert {m[0] for m in margins} <= {"relu", "leaky_relu", "max_pool3d"}
    assert all(m[1] == 0 and m[2] == 0.0 for m in margins)
    assert torch.equal(got_out, out)
    assert max(gradient_errors(net, twin).values()) <= 1e-5

    with torch.no_grad():
        for p in twin.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    margins = []
    run(twin, replay=iter(decisions), margins=margins)
    assert sum(m[1] for m in margins) > 0
    assert max(m[2] for m in margins) > 1e-3
