"""mmhand_torch's BatchNorm moments (the CPU side of kernels K2 and K2b) and
its train-mode BatchNorm2d against mmhand_tpu.

The cases are tests/test_bn_stats.py:27-75 with the port on one side: the
moments against JAX ``bn_moments(method="pallas")`` (the Pallas kernel in
interpret mode) and against the plain mean reductions, the backward against
``jax.grad``, and bf16 input summed in f32.  Then ``BatchNorm2d`` against JAX
``Norm`` on the Pallas statistics (``OpImpl(bn_stats="pallas",
bn_stats_min=0)``), in train and eval mode, with its running statistics and
its switch that leaves them alone.  Tolerances are the JAX tests' own:
f32 sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch.models import layers as tl
from mmhand_torch.ops import bn_stats as tbn
from mmhand_torch.utils import trace
from mmhand_tpu.models import layers as jl
from mmhand_tpu.ops.bn_stats import bn_moments as jax_bn_moments

PALLAS = jl.OpImpl(bn_stats="pallas", bn_stats_min=0)


def _nchw(x, dtype=torch.float32):
    """NHWC numpy -> NCHW torch in channels_last memory, as the networks
    hand their BatchNorms."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).permute(0, 3, 1, 2)


def _jax_reduce(x):
    xf = jnp.asarray(x, jnp.float32)
    return xf.mean((0, 1, 2)), (xf * xf).mean((0, 1, 2))


@pytest.mark.parametrize("against", ["pallas", "reduce"])
def test_moments_match_jax(against):
    x = np.random.RandomState(0).normal(size=(4, 9, 7, 13)).astype(np.float32)
    want = (jax_bn_moments(jnp.asarray(x), method="pallas")
            if against == "pallas" else _jax_reduce(x))
    got = tbn.bn_moments(_nchw(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (13,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("against", ["pallas", "reduce"])
def test_backward_matches_jax_grad(against):
    rng = np.random.RandomState(1)
    x = rng.normal(size=(2, 5, 5, 3)).astype(np.float32)
    co_mu = rng.normal(size=3).astype(np.float32)
    co_mu2 = rng.normal(size=3).astype(np.float32)

    def loss(xj):
        mu, mu2 = (jax_bn_moments(xj, method="pallas") if against == "pallas"
                   else _jax_reduce(xj))
        return jnp.vdot(mu, co_mu) + jnp.vdot(mu2, co_mu2)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    xt = _nchw(x).requires_grad_()
    mu, mu2 = tbn.bn_moments(xt)
    (mu @ torch.from_numpy(co_mu) + mu2 @ torch.from_numpy(co_mu2)).backward()
    got = xt.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bf16_input_accumulates_f32():
    x = np.random.RandomState(4).normal(size=(8, 16, 16, 5)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jax_bn_moments(xb, method="pallas")
    got = tbn.bn_moments(_nchw(x, torch.bfloat16))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_backward_keeps_dtype_and_layout():
    """K2b's contract, on its plain version: dx in x's dtype and in
    channels_last memory, g1 + 2 g2 x in that order."""
    x = _nchw(np.random.RandomState(5).normal(size=(2, 4, 3, 6)),
              torch.bfloat16)
    g1, g2 = torch.randn(6), torch.randn(6)
    dx = tbn.bn_sums_backward(x, g1, g2)
    assert dx.dtype == torch.bfloat16
    assert dx.is_contiguous(memory_format=torch.channels_last)
    want = (g1.view(1, -1, 1, 1) + (2 * g2).view(1, -1, 1, 1) * x.float())
    assert torch.equal(dx, want.to(torch.bfloat16))


def test_kernel_input_checks():
    """What the CUDA wrappers refuse, checked before any launch."""
    x = torch.zeros(2, 8, 4, 4)
    with pytest.raises(ValueError, match="channels_last"):
        tbn.rows_view(x)
    with pytest.raises(TypeError):
        tbn.rows_view(x.double().contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError):
        tbn.rows_view(torch.zeros(8, 4))
    assert tbn.rows_view(x.contiguous(memory_format=torch.channels_last)) == (32, 8)
    counted = trace.counters()
    assert counted.get("k2.launches", 0) == counted.get("k2b.launches", 0) == 0


def _jax_norm(x, train, stats):
    layer = jl.Norm(jl.NormConfig(kind="batch"), dtype=jnp.float32, impl=PALLAS)
    variables = layer.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    out = layer.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                      train=train, mutable=["batch_stats"] if train else False)
    y, new = out if train else (out, {"batch_stats": stats})
    return params["BatchNorm_0"], np.asarray(y), new["batch_stats"]["BatchNorm_0"]


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_matches_jax_pallas_norm(train):
    rng = np.random.RandomState(6)
    x = rng.normal(0.3, 1.5, (2, 6, 6, 4)).astype(np.float32)
    stats = {"BatchNorm_0": {"mean": rng.normal(0, .2, 4).astype(np.float32),
                             "var": rng.uniform(.5, 2, 4).astype(np.float32)}}
    params, want, new_stats = _jax_norm(x, train, stats)
    bn = tl.BatchNorm2d(4)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.array(params["scale"])))
        bn.bias.copy_(torch.from_numpy(np.array(params["bias"])))
        bn.running_mean.copy_(torch.from_numpy(stats["BatchNorm_0"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["BatchNorm_0"]["var"]))
        got = bn.train(train)(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new_stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new_stats["var"]), atol=1e-6)


def test_frozen_running_stats_skips_the_update():
    """Inside ``frozen_running_stats`` a train-mode forward normalizes with
    the batch moments as always and leaves the running statistics alone;
    afterwards the updates resume."""
    x = _nchw(np.random.RandomState(7).normal(1.0, 2.0, (2, 5, 5, 3)))
    net = torch.nn.Sequential(tl.BatchNorm2d(3)).train()
    bn = net[0]
    want = bn(x)
    before = (bn.running_mean.clone(), bn.running_var.clone(),
              int(bn.num_batches_tracked))
    with tl.frozen_running_stats(net):
        got = bn(x)
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, before[0])
    assert torch.equal(bn.running_var, before[1])
    assert int(bn.num_batches_tracked) == before[2]
    assert bn.update_running_stats
    bn(x)
    assert not torch.equal(bn.running_mean, before[0])
