"""mmhand_torch's Discriminator against its mmhand_tpu twin.

Same numpy inputs and the same weights (drawn by JAX, carried over with
mmhand_torch/convert.py) in float32 on the CPU.  Tolerance atol 2e-5 in eval
mode, as tests/test_torch_models.py; train mode normalizes with batch
statistics over as few as 2 x 4 x 4 samples, where a small variance
amplifies f32 rounding, hence atol 1e-4 there.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from convert_mmhand_torch import convert_discriminator  # noqa: E402

from mmhand_torch.convert import discriminator_state_dict_from_jax  # noqa: E402
from mmhand_torch.models.discriminator import Discriminator  # noqa: E402
from mmhand_torch.utils.checkpoint import load_state_dict  # noqa: E402
from mmhand_tpu.models import discriminator as jdisc  # noqa: E402
from mmhand_tpu.models import layers as jl  # noqa: E402

NDF, SIZE, BLOCKS, IN_NC = 8, 32, 2, 24
CASES = [(2, True, "reflect"), (3, False, "reflect"), (2, False, "zero")]


def _stats(rng, tree):
    if set(tree) == {"mean", "var"}:
        return {"mean": rng.normal(0, .2, tree["mean"].shape).astype(np.float32),
                "var": rng.uniform(.5, 2, tree["var"].shape).astype(np.float32)}
    return {k: _stats(rng, v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)  # eager flax init costs seconds per config
def _jax_discriminator(n_down, use_dropout, pad_mode):
    d = jdisc.Discriminator(ndf=NDF, n_blocks=BLOCKS, n_downsampling=n_down,
                            norm=jl.NormConfig(kind="batch"),
                            use_dropout=use_dropout, pad_mode=pad_mode,
                            dtype=jnp.float32)
    variables = d.init(jax.random.PRNGKey(n_down),
                       jnp.zeros((2, SIZE, SIZE, IN_NC)), train=False)
    return d, {"params": jax.tree_util.tree_map(np.asarray, variables["params"]),
               "batch_stats": _stats(np.random.RandomState(n_down),
                                     variables["batch_stats"])}


def _port(variables, n_down, use_dropout, pad_mode):
    d = Discriminator(IN_NC, ndf=NDF, n_blocks=BLOCKS, n_downsampling=n_down,
                      use_dropout=use_dropout, pad_mode=pad_mode,
                      compute_dtype=None)
    d.load_state_dict(discriminator_state_dict_from_jax(
        variables, use_dropout=use_dropout, pad_mode=pad_mode))
    return d.to(memory_format=torch.channels_last)


def _x(seed=0):
    return np.random.RandomState(seed).uniform(
        -1, 1, (2, SIZE, SIZE, IN_NC)).astype(np.float32)


@pytest.mark.parametrize("n_down,use_dropout,pad_mode", CASES)
def test_eval_matches_jax(n_down, use_dropout, pad_mode):
    d, variables = _jax_discriminator(n_down, use_dropout, pad_mode)
    x = _x()
    want = np.asarray(d.apply(variables, jnp.asarray(x), train=False))
    port = _port(variables, n_down, use_dropout, pad_mode).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    # no 1-channel projection: the logits are the ndf*4-wide feature map
    side = SIZE // 2 ** n_down
    assert got.shape == want.shape == (2, side, side, NDF * 4)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("n_down", [2, 3])
def test_train_mode_and_running_stats_match_jax(n_down):
    """Dropout off on both sides (their random masks cannot agree)."""
    d, variables = _jax_discriminator(n_down, False, "reflect")
    x = _x(1)
    want, new = d.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    port = _port(variables, n_down, False, "reflect").train()
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    want_sd = discriminator_state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               new["batch_stats"])},
        use_dropout=False)
    keys = [k for k in want_sd if "running" in k]
    assert len(keys) == 2 * (1 + n_down + 2 * BLOCKS)
    for k in keys:
        np.testing.assert_allclose(port.state_dict()[k].numpy(),
                                   want_sd[k].numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("n_down,use_dropout,pad_mode", CASES)
def test_convert_round_trip(n_down, use_dropout, pad_mode, tmp_path):
    """JAX tree -> port state_dict -> tools/convert_mmhand_torch.py gives the
    JAX tree back, leaf for leaf; also from a reference-style checkpoint
    whose keys carry the ``model.`` prefix."""
    _, variables = _jax_discriminator(n_down, use_dropout, pad_mode)
    sd = _port(variables, n_down, use_dropout, pad_mode).state_dict()
    path = tmp_path / "netD.pth"
    torch.save({f"model.{k}": v for k, v in sd.items()}, path)
    assert load_state_dict(str(path)).keys() == sd.keys()
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    for source in (sd, {f"model.{k}": v for k, v in sd.items()}):
        back = convert_discriminator(source, n_downsampling=n_down)
        flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_a) == len(flat_b)
        for p, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[p], leaf, err_msg=str(p))
