"""mmhand_torch layers and Generator against their mmhand_tpu twins.

Same inputs, made with numpy from a seed, and the same weights go through
both packages, in float32 on the CPU.  Tolerance: atol 2e-5 unless stated,
as tests/test_torch_parity.py:66 uses for the reference torch generator; the
two frameworks sum the conv taps in another order.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from convert_mmhand_torch import convert_generator  # noqa: E402

from mmhand_torch.convert import generator_state_dict_from_jax  # noqa: E402
from mmhand_torch.models import layers as tl  # noqa: E402
from mmhand_torch.models.generator import Generator  # noqa: E402
from mmhand_tpu.models import generator as jgen  # noqa: E402
from mmhand_tpu.models import layers as jl  # noqa: E402

ATOL = 2e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k), (3, 2, 0, 1))))


def _stats_tree(rng, tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"mean", "var"}:
            out[k] = {"mean": rng.normal(0.0, 0.2, v["mean"].shape
                                         ).astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, v["var"].shape
                                         ).astype(np.float32)}
        else:
            out[k] = _stats_tree(rng, v)
    return out


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,kernel", [("reflect", 3), ("replicate", 3),
                                         ("zero", 3), ("reflect", 7)])
def test_pad_conv_matches_jax(mode, kernel):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 16, 16, 5)).astype(np.float32)
    pad = kernel // 2
    layer = jl.PadConv(6, kernel, pad=pad, pad_mode=mode, use_bias=True,
                       dtype=jnp.float32)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = dict(params, bias=rng.normal(0, 0.1, 6).astype(np.float32))
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))

    seq = nn.Sequential(*tl.pad_conv(5, 6, kernel, pad=pad, pad_mode=mode))
    conv = seq[-1]
    with torch.no_grad():
        conv.weight.copy_(_oihw(params["kernel"]))
        conv.bias.copy_(torch.from_numpy(params["bias"]))
        got = _nhwc(seq(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_strided_conv_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (2, 16, 16, 8)).astype(np.float32)
    layer = jl.StridedConv(12, dtype=jnp.float32)
    params = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))

    conv = tl.strided_conv(8, 12)
    with torch.no_grad():
        conv.weight.copy_(_oihw(params["Conv_0"]["kernel"]))
        got = _nhwc(conv(_nchw(x)))
    assert got.shape == (2, 8, 8, 12)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_up_conv_matches_jax_default():
    """Against the JAX UpConv's default lowering ('conv4'); the weight
    carries over as the converter's inverse: (kh,kw,I,O) -> (I,O,kh,kw),
    then both spatial axes flipped."""
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (2, 8, 8, 16)).astype(np.float32)
    layer = jl.UpConv(8, dtype=jnp.float32)
    assert layer.impl.upconv_shuffle == "conv4"
    params = layer.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))

    conv = tl.up_conv(16, 8)
    w = np.transpose(np.asarray(params["kernel"]), (2, 3, 0, 1))[:, :, ::-1, ::-1]
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
        got = _nhwc(conv(_nchw(x)))
    assert got.shape == (2, 16, 16, 8)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_matches_jax(train):
    """Train mode also pins the running-variance rule: flax folds the biased
    batch variance, torch's stock BatchNorm2d the unbiased one."""
    rng = np.random.RandomState(3)
    x = rng.normal(0.3, 1.5, (2, 6, 6, 4)).astype(np.float32)
    layer = jl.Norm(jl.NormConfig(kind="batch"), dtype=jnp.float32)
    variables = layer.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
    stats = _stats_tree(rng, variables["batch_stats"])
    params = variables["params"]
    out = layer.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), train=train,
                      mutable=["batch_stats"] if train else False)
    want, new_stats = (out if train else (out, {"batch_stats": stats}))

    bn = tl.norm_layer(tl.NormConfig("batch"), 4)
    p, s = params["BatchNorm_0"], stats["BatchNorm_0"]
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.array(p["scale"])))
        bn.bias.copy_(torch.from_numpy(np.array(p["bias"])))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
        got = _nhwc(bn.train(train)(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    ns = new_stats["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(ns["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(ns["var"]),
                               atol=1e-6)


def test_instance_norm_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.normal(0.3, 1.5, (2, 6, 6, 4)).astype(np.float32)
    layer = jl.Norm(jl.NormConfig(kind="instance"), dtype=jnp.float32)
    variables = layer.init(jax.random.PRNGKey(4), jnp.asarray(x))
    want = np.asarray(layer.apply(variables, jnp.asarray(x)))
    norm = tl.norm_layer(tl.NormConfig("instance"), 4)
    assert not list(norm.parameters())
    with torch.no_grad():
        got = _nhwc(norm(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_init_types_other_than_normal_raise():
    """Only the reference's four init types exist (the other three are
    held against mmhand_tpu in tests/test_torch_zoo.py)."""
    with pytest.raises(NotImplementedError, match="uniform"):
        tl.init_weights(nn.Conv2d(3, 3, 3), "uniform")


# --------------------------------------------------------------------------
# Generator
# --------------------------------------------------------------------------

NGF, SIZE = 8, 32


def _inputs(seed=0, batch=2):
    rng = np.random.RandomState(seed)
    return tuple(rng.uniform(-1, 1, (batch, SIZE, SIZE, c)).astype(np.float32)
                 for c in (3, 42, 6))


@functools.lru_cache(maxsize=None)  # eager flax init costs seconds per config
def _jax_generator(n_blocks, use_dropout, pad_mode, seed=0):
    g = jgen.Generator(ngf=NGF, n_blocks=n_blocks, use_dropout=use_dropout,
                       norm=jl.NormConfig(kind="batch"), pad_mode=pad_mode,
                       dtype=jnp.float32)
    x = tuple(jnp.zeros((2, SIZE, SIZE, c)) for c in (3, 42, 6))
    variables = g.init({"params": jax.random.PRNGKey(seed),
                        "dropout": jax.random.PRNGKey(seed + 1)},
                       x, train=False)
    rng = np.random.RandomState(seed + 100)
    variables = {"params": jax.tree_util.tree_map(np.asarray,
                                                  variables["params"]),
                 "batch_stats": _stats_tree(rng, variables["batch_stats"])}
    return g, variables


def _port_generator(variables, n_blocks, use_dropout, pad_mode):
    g = Generator(ngf=NGF, n_blocks=n_blocks, use_dropout=use_dropout,
                  pad_mode=pad_mode, compute_dtype=None)
    g.load_state_dict(generator_state_dict_from_jax(
        variables, use_dropout=use_dropout, pad_mode=pad_mode))
    return g.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("n_blocks,use_dropout,pad_mode", [
    (2, True, "reflect"), (9, True, "reflect"),
    (2, False, "replicate"), (2, False, "zero")])
def test_generator_eval_matches_jax(n_blocks, use_dropout, pad_mode):
    g, variables = _jax_generator(n_blocks, use_dropout, pad_mode)
    x = _inputs()
    want = np.asarray(g.apply(variables, tuple(map(jnp.asarray, x)),
                              train=False))
    port = _port_generator(variables, n_blocks, use_dropout, pad_mode).eval()
    with torch.no_grad():
        got = port(tuple(torch.from_numpy(a) for a in x)).numpy()
    assert got.shape == (2, SIZE, SIZE, 3) and got.dtype == np.float32
    assert np.abs(want).max() > 0.02  # a signal, not a flat map
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_generator_train_mode_matches_jax():
    """Dropout off on both sides (their random masks cannot agree).  Batch
    statistics over 2 samples at 8x8 leave some channels with a small
    variance that amplifies f32 rounding, hence atol 1e-4 on the output."""
    g, variables = _jax_generator(2, False, "reflect")
    x = _inputs(seed=5)
    want, new = g.apply(variables, tuple(map(jnp.asarray, x)), train=True,
                        mutable=["batch_stats"])
    port = _port_generator(variables, 2, False, "reflect").train()
    got = port(tuple(torch.from_numpy(a) for a in x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)

    want_sd = generator_state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               new["batch_stats"])},
        use_dropout=False)
    got_sd = port.state_dict()
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * (3 * 3 + 2 * 3 + 2 + 2)
    for k in keys:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("n_blocks", [2, 9])
def test_convert_round_trip(n_blocks):
    """JAX tree -> port state_dict -> tools/convert_mmhand_torch.py gives the
    JAX tree back, leaf for leaf."""
    _, variables = _jax_generator(n_blocks, True, "reflect")
    port = _port_generator(variables, n_blocks, True, "reflect")
    back = convert_generator(port.state_dict())

    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))
