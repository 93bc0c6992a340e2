"""The port's Inception-v3 and its preprocess against mmhand_tpu's.

Both nets get the same weights through the npz path a converted torchvision
checkpoint takes: the port's random net, with drawn BatchNorm parameters and
running statistics, is saved as an npz of its state_dict and read by
mmhand_tpu's ``load_inception_npz``.  Float32 on the CPU; logits and pool
features at rtol/atol 1e-4 (the two frameworks sum the conv taps in another
order, over 94 convolutions), the preprocess within 1e-6 (bilinear weights
rounded in another order, then divided by std ~0.22).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch.convert import inception_state_dict_from_jax
from mmhand_torch.models import inception as tinc
from mmhand_tpu.models import inception as jinc


def _draw_bn(net, rng):
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, n).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)))


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    net = tinc.init_fan_in(tinc.Inception3(), torch.Generator().manual_seed(0))
    _draw_bn(net, np.random.RandomState(0))
    path = str(tmp_path_factory.mktemp("inception") / "inception_v3.npz")
    np.savez(path, **{k: v.numpy() for k, v in net.state_dict().items()})
    variables = jinc.load_inception_npz(path)
    fwd = jax.jit(lambda v, x: jinc.Inception3(dtype=jnp.float32).apply(
        v, jinc.inception_preprocess(x)))
    return net.eval(), variables, fwd, path


def test_forward_matches_jax(nets):
    net, variables, fwd, _ = nets
    x = np.random.RandomState(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want_logits, want_pool = fwd(variables, x)
    with torch.no_grad():
        logits, pool = net(tinc.inception_preprocess(torch.from_numpy(x)))
    assert logits.shape == (2, 1000) and pool.shape == (2, 2048)
    assert logits.dtype == pool.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pool.numpy(), np.asarray(want_pool),
                               rtol=1e-4, atol=1e-4)
    # a signal, not a constant: the images are told apart
    assert float((logits[0] - logits[1]).abs().max()) > 1e-2


@pytest.mark.parametrize("size", [32, 256])
def test_preprocess_matches_jax(size):
    x = np.random.RandomState(size).uniform(-1, 1, (2, size, size, 3)
                                            ).astype(np.float32)
    got = tinc.inception_preprocess(torch.from_numpy(x))
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jinc.inception_preprocess(x)), rtol=0, atol=1e-6)


def test_preprocess_refuses_downsampling():
    """Above 299 px jax.image.resize antialiases and F.interpolate here does
    not, so the port refuses rather than score differently."""
    with pytest.raises(ValueError, match="exceed 299 px"):
        tinc.inception_preprocess(torch.zeros(1, 300, 256, 3))


def test_npz_round_trip(nets):
    """The port's npz loader reads what it saved, and the JAX tree converts
    back to the same state_dict: convert.py inverts mmhand_tpu's loader."""
    net, variables, _, path = nets
    loaded = tinc.load_inception_npz(path)
    want = net.state_dict()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want[k]), k
    back = inception_state_dict_from_jax(variables)
    assert set(back) == set(want)
    for k, v in back.items():
        assert torch.equal(v, want[k]), k


def test_npz_loader_drops_aux_head_and_refuses_strangers(tmp_path, nets):
    net = nets[0]
    sd = {k: v.numpy() for k, v in net.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    path = tmp_path / "aux.npz"
    np.savez(path, **sd, **{"AuxLogits.fc.weight": np.zeros((2, 2), np.float32)})
    tinc.load_inception_npz(str(path))
    np.savez(path, **sd, **{"Mixed_9.conv.weight": np.zeros(1, np.float32)})
    with pytest.raises(KeyError):
        tinc.load_inception_npz(str(path))


def test_module_names_are_torchvision_keys(nets):
    keys = set(nets[0].state_dict())
    for k in ("Conv2d_1a_3x3.conv.weight", "Mixed_5b.branch_pool.bn.running_var",
              "Mixed_6e.branch7x7dbl_5.conv.weight", "Mixed_7c.branch3x3_2b.bn.bias",
              "fc.weight", "fc.bias"):
        assert k in keys
    assert sum(p.numel() for p in nets[0].parameters()) == 23_834_568
