"""The port's jointsmap-conditioned baseline generators against mmhand_tpu's.

mmhand_tpu's random init (with drawn running statistics) goes to the port
through ``convert.py``; both run in float32 on the CPU at 32 px, in eval
mode.  Outputs at atol 1e-5 (tanh outputs; conv taps summed in another
order).
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch.convert import (
    resnet_generator_state_dict_from_jax,
    unet_generator_state_dict_from_jax,
)
from mmhand_torch.models import baselines as tbase
from mmhand_tpu.models import baselines as jbase

REPO = Path(__file__).resolve().parent.parent
SIZE = 32
CASES = {
    "resnet": (lambda: jbase.ResnetGenerator(ngf=8, n_blocks=2, dtype=jnp.float32),
               lambda: tbase.ResnetGenerator(ngf=8, n_blocks=2, compute_dtype=None),
               resnet_generator_state_dict_from_jax),
    "unet": (lambda: jbase.UnetGenerator(ngf=8, num_downs=5, dtype=jnp.float32),
             lambda: tbase.UnetGenerator(ngf=8, num_downs=5, compute_dtype=None),
             unet_generator_state_dict_from_jax),
    "unet7": (lambda: jbase.UnetGenerator(ngf=4, num_downs=7, dtype=jnp.float32),
              lambda: tbase.UnetGenerator(ngf=4, num_downs=7, compute_dtype=None),
              unet_generator_state_dict_from_jax),
}


def _drawn_variables(net, size, seed=0):
    v = jax.jit(lambda r: net.init(r, jnp.zeros((1, size, size, 3)),
                                   train=False))(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.005, 0.05, a.shape)
                         if path[-1].key == "var"
                         else rng.normal(0, 0.05, a.shape)).astype(np.float32),
        v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_forward_matches_jax(arch):
    make_jax, make_port, convert = CASES[arch]
    size = 128 if arch == "unet7" else SIZE
    jax_net = make_jax()
    variables = _drawn_variables(jax_net, size)
    port = make_port()
    sd = convert(variables)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    port.eval()
    x = np.random.RandomState(1).uniform(0, 1, (2, size, size, 3)
                                         ).astype(np.float32)
    want = np.asarray(jax_net.apply(variables, x, train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, size, size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.std() > 0.05  # the drawn statistics lift a real signal
    n_jax = sum(a.size for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax


def test_reference_layout_keys():
    """The keys tools/convert_baselines_torch.py parses."""
    resnet = tbase.ResnetGenerator(ngf=8, n_blocks=2).state_dict()
    assert {"1.weight", "2.running_var", "4.weight", "10.conv_block.1.weight",
            "10.conv_block.6.running_mean", "12.weight", "13.weight",
            "19.weight", "19.bias"} <= set(resnet)
    unet = tbase.UnetGenerator(ngf=8, num_downs=5).state_dict()
    assert {"model.model.0.weight", "model.model.3.weight",
            "model.model.3.bias", "model.model.1.model.1.weight",
            "model.model.1.model.2.running_mean",
            "model.model.1.model.3.model.3.model.3.model.1.weight",
            "model.model.1.model.3.model.3.model.3.model.4.running_var",
            } <= set(unet)
    assert "model.model.0.bias" not in unet


@pytest.mark.parametrize("arch", ["resnet", "unet7"])
def test_convert_is_the_inverse_of_the_tools_converter(arch, monkeypatch):
    """tools/convert_baselines_torch.py reads the port's state_dict back
    into the very variables it came from."""
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    tools = importlib.import_module("convert_baselines_torch")
    make_jax, _, convert = CASES[arch]
    variables = _drawn_variables(make_jax(), 128, seed=2)
    sd = {k: v.numpy() for k, v in convert(variables).items()}
    back = (tools.convert_resnet_generator(sd) if arch == "resnet"
            else tools.convert_unet_generator(sd, num_downs=7))
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))
