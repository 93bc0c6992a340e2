"""The rest of the 2D baseline zoo and the init types, against mmhand_tpu.

* PATN2Stream, NLayerDiscriminator and PixelDiscriminator: mmhand_tpu's
  random init, with drawn running statistics, goes to the port through
  ``convert.py``.  PoseResNet 18 and 50: the port's weights go to
  mmhand_tpu through its own ``load_pose_resnet_state_dict`` (the reference
  torch layout) and come back through ``convert.py``.  Both packages run in
  float32 on the CPU, in eval mode and in train mode (batch statistics, the
  running statistics after one step); outputs at atol 1e-5, as
  tests/test_torch_baselines.py.  One JAX jit per net does both modes.
* ``init_weights``: xavier, kaiming and orthogonal redraw exactly the
  tensors mmhand_tpu's ``apply_init_type`` redraws, with its std (its fans,
  a ConvTranspose's included), and orthogonal weights are semi-orthogonal
  with the output features as rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch import convert
from mmhand_torch.config import Config, DataConfig, ModelConfig
from mmhand_torch.data.preprocess import create_rhd_db
from mmhand_torch.data.raw_sources import write_raw_rhd
from mmhand_torch.models import baselines as tbase
from mmhand_torch.models import layers as tlayers
from mmhand_torch.models.check_nets import make_test_pose_resnet
from mmhand_torch.models.generator import Generator
from mmhand_torch.scripts import bench_baselines
from mmhand_tpu.models import baselines as jbase
from mmhand_tpu.models import generator as jgen
from mmhand_tpu.models import layers as jlayers
from test_torch_threads import two_threads  # noqa: F401

ATOL = 1e-5


def _drawn_stats(stats, seed):
    """Running statistics that lift the N(0, 0.02) init's small activations
    to a real signal (as tests/test_torch_baselines.py draws them)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.005, 0.05, a.shape)
                         if path[-1].key == "var"
                         else rng.normal(0, 0.05, a.shape)).astype(np.float32),
        stats)


def _jax_init(net, example, seed=0):
    v = jax.jit(lambda r: net.init({"params": r}, example, train=False))(
        jax.random.PRNGKey(seed))
    return {"params": v["params"],
            "batch_stats": _drawn_stats(v["batch_stats"], seed)}


def _pose_resnet_case(size):
    port = make_test_pose_resnet(size, seed=size)
    # copies: mmhand_tpu's loader keeps numpy views, which jax may alias
    sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    variables = jbase.load_pose_resnet_state_dict(sd, resnet_size=size)
    return (jbase.PoseResNet(resnet_size=size, dtype=jnp.float32), variables,
            lambda: tbase.PoseResNet(resnet_size=size, compute_dtype=None),
            convert.pose_resnet_state_dict_from_jax)


def _case(name):
    """(JAX net, its variables, a fresh port net, the converter, input)."""
    rng = np.random.RandomState(7)
    if name == "patn2":
        x = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
             rng.uniform(0, 1, (2, 32, 32, 42)).astype(np.float32))
        # dropout in train mode draws differently in the two frameworks
        net = jbase.PATN2Stream(ngf=8, n_blocks=2, use_dropout=False,
                                dtype=jnp.float32)
        return (net, _jax_init(net, x),
                lambda: tbase.PATN2Stream(ngf=8, n_blocks=2, use_dropout=False,
                                          compute_dtype=None),
                lambda v: convert.patn2_state_dict_from_jax(v, use_dropout=False),
                x)
    if name == "patn2_dropout":  # eval mode, with the dropout layers' indices
        x = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
             rng.uniform(0, 1, (2, 32, 32, 42)).astype(np.float32))
        net = jbase.PATN2Stream(ngf=8, n_blocks=2, dtype=jnp.float32)
        return (net, _jax_init(net, x),
                lambda: tbase.PATN2Stream(ngf=8, n_blocks=2, compute_dtype=None),
                convert.patn2_state_dict_from_jax, x)
    if name == "nlayer":
        x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
        net = jbase.NLayerDiscriminator(ndf=8, dtype=jnp.float32)
        return (net, _jax_init(net, x),
                lambda: tbase.NLayerDiscriminator(ndf=8, compute_dtype=None),
                convert.nlayer_discriminator_state_dict_from_jax, x)
    if name == "pixel":
        x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        net = jbase.PixelDiscriminator(ndf=8, dtype=jnp.float32)
        return (net, _jax_init(net, x),
                lambda: tbase.PixelDiscriminator(ndf=8, compute_dtype=None),
                convert.pixel_discriminator_state_dict_from_jax, x)
    size = int(name.removeprefix("pose_resnet"))
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    return (*_pose_resnet_case(size), x)


def _to_torch(x):
    if isinstance(x, tuple):
        return tuple(torch.from_numpy(a) for a in x)
    return torch.from_numpy(x)


@pytest.mark.parametrize("name", ["patn2", "patn2_dropout", "nlayer", "pixel",
                                  "pose_resnet18", "pose_resnet50"])
def test_forward_matches_jax(name):
    """Eval mode, then one train-mode forward: its output and the running
    statistics it leaves."""
    jax_net, variables, make_port, to_port, x = _case(name)
    port = make_port()
    sd = to_port(variables)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    n_jax = sum(a.size for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax

    @jax.jit
    def both(v, inputs):
        evald = jax_net.apply(v, inputs, train=False)
        trained, upd = jax_net.apply(v, inputs, train=True,
                                     mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(0)})
        return evald, trained, upd["batch_stats"]

    want_eval, want_train, new_stats = both(variables, x)
    port.eval()
    with torch.no_grad():
        got = port(_to_torch(x)).numpy()
    assert got.shape == want_eval.shape
    np.testing.assert_allclose(got, np.asarray(want_eval), rtol=0, atol=ATOL)
    assert got.std() > 10 * ATOL  # a real signal, not a vanished one
    if name == "patn2_dropout":
        return
    port.train()
    with torch.no_grad():
        got = port(_to_torch(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want_train), rtol=0, atol=ATOL)
    want_sd = to_port({"params": variables["params"],
                       "batch_stats": new_stats})
    stats = 0
    for key, value in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), want_sd[key].numpy(),
                                       rtol=1e-5, atol=ATOL, err_msg=key)
            stats += 1
    assert stats == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                            for m in port.modules()) > 0


@pytest.mark.parametrize("size", [18, 50])
def test_pose_resnet_keys_are_the_references(size):
    """Every tensor of the port's state_dict is one that mmhand_tpu's
    ``load_pose_resnet_state_dict`` reads (the reference's names), and
    ``convert`` gives that state_dict back exactly; the port's loader takes
    a DataParallel checkpoint without ``num_batches_tracked`` strictly."""
    port = make_test_pose_resnet(size, seed=size)
    sd = port.state_dict()
    variables = jbase.load_pose_resnet_state_dict(
        {k: v.numpy().copy() for k, v in sd.items()}, resnet_size=size)
    n_leaves = len(jax.tree.leaves(variables))
    assert n_leaves == sum(not k.endswith("num_batches_tracked") for k in sd)
    back = convert.pose_resnet_state_dict_from_jax(variables)
    assert set(back) == set(sd)
    for k, v in back.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    assert {"conv1.weight", "bn1.running_var", "layer1.0.conv1.weight",
            "layer2.0.downsample.0.weight", "layer2.0.downsample.1.weight",
            "deconv_layers.0.weight", "deconv_layers.1.running_mean",
            "deconv_layers.7.bias", "final_layer.weight",
            "final_layer.bias"} <= set(sd)
    assert (f"layer1.0.conv3.weight" in sd) == (size == 50)
    assert sum(isinstance(m, torch.nn.BatchNorm2d)
               for m in port.modules()) == {18: 23, 50: 56}[size]
    reference = {f"module.{k}": v.numpy() for k, v in sd.items()
                 if not k.endswith("num_batches_tracked")}
    loaded = tbase.load_pose_resnet_state_dict(reference, resnet_size=size,
                                               compute_dtype=None)
    for k, v in loaded.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        tbase.load_pose_resnet_state_dict({**reference, "extra.weight":
                                           np.zeros(1)}, resnet_size=size)


# --------------------------------------------------------------------------
# init types

NGF = 8


@pytest.fixture(scope="module")
def generators():
    """A toy mmhand_tpu Generator's variables and the port's counterpart."""
    x = tuple(np.zeros((1, 32, 32, c), np.float32) for c in (3, 42, 6))
    jax_net = jgen.Generator(ngf=NGF, n_blocks=2, dtype=jnp.float32)
    variables = jax.jit(lambda r: jax_net.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(0))
    return variables


def _redrawn(before: dict, after: dict) -> set:
    return {k for k in before if not torch.equal(before[k], after[k])}


def _std_bound(n: int) -> float:
    """Six standard errors of a sample std, relative."""
    return 6.0 / np.sqrt(2.0 * n)


@pytest.mark.parametrize("init_type", ["xavier", "kaiming", "orthogonal"])
def test_init_type_redraws_what_jax_redraws(generators, init_type):
    variables = generators
    params = variables["params"]
    jax_new = jlayers.apply_init_type(params, init_type, jax.random.PRNGKey(3))
    to_port = convert.generator_state_dict_from_jax
    old_sd = to_port(variables)
    jax_sd = to_port({"params": jax_new,
                      "batch_stats": variables["batch_stats"]})
    want = _redrawn(old_sd, jax_sd)

    net = Generator(ngf=NGF, n_blocks=2, compute_dtype=None)
    normal = tlayers.init_weights(net, "normal", torch.Generator().manual_seed(5))
    normal_sd = {k: v.clone() for k, v in normal.state_dict().items()}
    typed = tlayers.init_weights(net, init_type,
                                 torch.Generator().manual_seed(5)).state_dict()
    got = _redrawn(normal_sd, typed)
    convs = {f"{name}.weight" for name, m in net.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))}
    assert got == want == convs

    for name, m in net.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert not m.bias.any()
            assert abs(float(m.weight.mean()) - 1) < 0.05
        if not isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            continue
        if m.bias is not None:
            assert not m.bias.any()
        w, jw = m.weight, jax_sd[f"{name}.weight"]
        fan_in, fan_out, cout = tlayers.weight_fans(m)
        if init_type == "orthogonal":
            for mat in (w, jw):  # rows are the output features
                rows = (mat.transpose(0, 1) if isinstance(
                    m, torch.nn.ConvTranspose2d) else mat).reshape(cout, -1)
                gram = rows @ rows.T if rows.shape[0] <= rows.shape[1] \
                    else rows.T @ rows
                torch.testing.assert_close(gram, torch.eye(len(gram)),
                                           rtol=0, atol=1e-5)
            continue
        std = (0.02 * (2.0 / (fan_in + fan_out)) ** 0.5
               if init_type == "xavier" else (2.0 / fan_in) ** 0.5)
        bound = _std_bound(w.numel())
        for tensor in (w, jw):
            assert abs(float(tensor.detach().std()) / std - 1) < bound, name


def test_conv_transpose_fans_are_mmhand_tpus():
    """A ConvTranspose2d (in 32, out 8, 3x3) has fan_in 32 * 9, where
    torch's own rule gives 8 * 9."""
    m = torch.nn.ConvTranspose2d(32, 8, 3)
    assert tlayers.weight_fans(m) == (32 * 9, 8 * 9, 8)
    assert torch.nn.init._calculate_fan_in_and_fan_out(m.weight) == (72, 288)
    tlayers.init_weights(m, "kaiming", torch.Generator().manual_seed(0))
    assert abs(float(m.weight.detach().std()) / (2.0 / 288) ** 0.5 - 1) < _std_bound(
        m.weight.numel())
    lin = tlayers.init_weights(torch.nn.Linear(300, 200), "orthogonal",
                               torch.Generator().manual_seed(0))
    torch.testing.assert_close(lin.weight @ lin.weight.T, torch.eye(200),
                               rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="he_uniform"):
        tlayers.init_weights(m, "he_uniform")


def test_bench_baselines_patn2_on_a_crop_tree(tmp_path):
    """``--arch patn2`` scores a toy RHD crop tree: the source image and
    the P1/P2 heatmaps of ``make_prepare_batch`` go into PATN2Stream."""
    raw = write_raw_rhd(tmp_path / "raw", 4, seed=8)
    root = str(tmp_path / "rhd_test")
    n = create_rhd_db(raw, root, 32, workers=2)
    cfg = Config(model=ModelConfig(fine_size=32, ngf=8),
                 data=DataConfig(dataset="RHD", dataroot=root), is_train=False)
    with pytest.warns(UserWarning, match="RANDOM generator"):
        scores = bench_baselines.bench(cfg, "patn2", batch_size=2,
                                       device="cpu", n_blocks=2,
                                       with_pck=False)
    assert scores["images"] == n == 6
    assert all(np.isfinite(scores[k]) for k in ("IS_avg", "SSIM_avg", "fid"))


def test_patn2_checkpoint_in_reference_layout_loads(tmp_path):
    """A PoseTransfer generator checkpoint (PATNetwork's ``model.`` around
    the PATN model, DataParallel's ``module.``) loads through ``--ckpt``."""
    cfg = Config(model=ModelConfig(fine_size=32, ngf=8),
                 data=DataConfig(dataset="synthetic"), is_train=False)
    net = tlayers.init_weights(tbase.PATN2Stream(ngf=8, n_blocks=2),
                               "normal", torch.Generator().manual_seed(4))
    sd = net.state_dict()
    path = tmp_path / "latest_net_netG.pth"
    torch.save({f"module.model.{k}": v for k, v in sd.items()}, path)
    loaded = bench_baselines.build_baseline(cfg, "patn2", "cpu", str(path),
                                            n_blocks=2)
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    assert not loaded.training
