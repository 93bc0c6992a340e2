"""mmhand_torch's VGG features, losses and image pool against mmhand_tpu.

Same numpy inputs and the same VGG weights (drawn by JAX, carried over with
mmhand_torch/convert.py), float32 on the CPU.  Tolerances: the losses and
features sum convolution taps and means in another order (rtol 1e-5); the
pool moves whole images, so it matches exactly, with the swap coins and
slot ids drawn by ``jax.random`` as mmhand_tpu/train/pool.py:63-66 draws
them and fed to both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch.convert import vgg_state_dict_from_jax
from mmhand_torch.losses.gan import gan_loss
from mmhand_torch.losses.perceptual import L1PlusPerceptual
from mmhand_torch.models import vgg as tvgg
from mmhand_torch.train import pool as tpool
from mmhand_tpu.losses.gan import gan_loss as jax_gan_loss
from mmhand_tpu.losses.perceptual import L1PlusPerceptual as JaxL1PlusPerceptual
from mmhand_tpu.models import vgg as jvgg
from mmhand_tpu.train import pool as jpool

SIZE = 32


def _images(seed, batch=2, size=SIZE):
    return np.random.RandomState(seed).uniform(
        -1, 1, (batch, size, size, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_vgg(truncate_at):
    m = jvgg.VGG19Features(truncate_at=truncate_at, dtype=jnp.float32)
    variables = m.init(jax.random.PRNGKey(truncate_at),
                       jnp.zeros((1, SIZE, SIZE, 3)))
    return m, jax.tree_util.tree_map(np.asarray, variables)


def _port_vgg(truncate_at):
    _, variables = _jax_vgg(truncate_at)
    vgg = tvgg.VGG19Features(truncate_at, compute_dtype=None)
    vgg.load_state_dict(vgg_state_dict_from_jax(variables["params"]))
    return vgg.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("truncate_at", [3, 8])
def test_vgg_features_match_jax(truncate_at):
    m, variables = _jax_vgg(truncate_at)
    x = _images(0)
    want = np.asarray(m.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_vgg(truncate_at)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert [i for i, kind, _ in tvgg.torch_layer_sequence()] == list(range(37))
    assert tvgg.torch_layer_sequence() == jvgg.torch_layer_sequence()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_imagenet_renorm_matches_jax():
    x = _images(1)
    np.testing.assert_allclose(
        tvgg.imagenet_renorm(torch.from_numpy(x)).numpy(),
        np.asarray(jvgg.imagenet_renorm(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_load_vgg19_npz(tmp_path):
    """The tools/convert_torch_weights.py layout: features.<i>.{weight,bias}
    for the whole network; the loader keeps what the truncation uses."""
    rng = np.random.RandomState(2)
    raw, cin = {}, 3
    for idx, kind, width in tvgg.torch_layer_sequence():
        if kind == "conv":
            raw[f"features.{idx}.weight"] = rng.normal(
                size=(width, cin, 3, 3)).astype(np.float32)
            cin = width
            raw[f"features.{idx}.bias"] = rng.normal(size=width).astype(np.float32)
        if idx == 8:
            break
    np.savez(tmp_path / "vgg.npz", **raw)
    sd = tvgg.load_vgg19_npz(str(tmp_path / "vgg.npz"), truncate_at=3)
    assert sorted(sd) == ["0.bias", "0.weight", "2.bias", "2.weight"]
    tvgg.VGG19Features(3).load_state_dict(sd)
    want = jvgg.load_vgg19_npz(str(tmp_path / "vgg.npz"), truncate_at=3)
    back = vgg_state_dict_from_jax(want["params"])
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), back[k].numpy())


@pytest.mark.parametrize("percep_is_l1,lambdas", [
    (True, (10.0, 10.0)), (False, (10.0, 10.0)), (True, (0.0, 0.0))])
def test_l1_plus_perceptual_matches_jax(percep_is_l1, lambdas):
    _, variables = _jax_vgg(3)
    fake, real = _images(3), _images(4)
    want = JaxL1PlusPerceptual(lambda_l1=lambdas[0],
                               lambda_perceptual=lambdas[1],
                               perceptual_layers=3, percep_is_l1=percep_is_l1,
                               vgg_variables=variables, dtype=jnp.float32)(
        jnp.asarray(fake), jnp.asarray(real))
    loss = L1PlusPerceptual(_port_vgg(3), lambda_l1=lambdas[0],
                            lambda_perceptual=lambdas[1],
                            percep_is_l1=percep_is_l1)
    fake_t = torch.from_numpy(fake).requires_grad_()
    got = loss(fake_t, torch.from_numpy(real))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5,
                                   atol=1e-6)
    if lambdas[0]:
        got[0].backward()
        assert fake_t.grad is not None
    assert not any(p.requires_grad for p in loss.vgg.parameters())


@pytest.mark.parametrize("mode", ["vanilla", "lsgan"])
@pytest.mark.parametrize("target_is_real", [True, False])
def test_gan_loss_matches_jax(mode, target_is_real):
    logits = np.random.RandomState(5).normal(0, 8, (2, 4, 4, 32)).astype(np.float32)
    logits[0, 0, 0, :3] = [30.0, -30.0, 0.0]  # far into both tails
    want = float(jax_gan_loss(jnp.asarray(logits), target_is_real, mode))
    got = gan_loss(torch.from_numpy(logits), target_is_real, mode)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        gan_loss(torch.from_numpy(logits), True, "wgan")


def _jax_draws(rng, bsz, pool_size):
    """The coins and slots mmhand_tpu/train/pool.py:63-66 draws."""
    coins, slots = [], []
    for i in range(bsz):
        k_swap, k_slot = jax.random.split(jax.random.fold_in(rng, i))
        coins.append(float(jax.random.uniform(k_swap)))
        slots.append(int(jax.random.randint(k_slot, (), 0, pool_size)))
    return torch.tensor(coins), torch.tensor(slots)


@pytest.mark.parametrize("pool_size,batches", [
    (3, [2, 2, 2, 5, 5]),   # fill, fill across the edge, swaps, batch > pool
    (8, [3, 3, 3, 8, 8]),   # repeated slots within one batch
    (0, [2, 2])])           # pool 0 passes through
def test_pool_query_matches_jax(pool_size, batches):
    shape = (4, 4, 2)
    jstate = jpool.pool_init(pool_size, shape)
    tstate = tpool.pool_init(pool_size, shape, device="cpu")
    rng = np.random.RandomState(pool_size)
    swapped = 0
    for q, bsz in enumerate(batches):
        batch = rng.normal(size=(bsz, *shape)).astype(np.float32)
        key = jax.random.PRNGKey(100 * pool_size + q)
        jstate, want = jpool.pool_query(jstate, jnp.asarray(batch), key)
        coins, slots = _jax_draws(key, bsz, max(pool_size, 1))
        tstate, got = tpool.pool_query(tstate, torch.from_numpy(batch),
                                       coins, slots)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(tstate.images.numpy(),
                                      np.asarray(jstate.images))
        assert tstate.num == int(jstate.num)
        swapped += int((got.numpy() != batch).any(axis=(1, 2, 3)).sum())
    assert swapped > 0 or pool_size == 0


def test_pool_query_random_fills_then_replays():
    state = tpool.pool_init(4, (2, 2, 1), dtype=torch.bfloat16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = torch.randn(4, 2, 2, 1)
    state, out = tpool.pool_query_random(state, batch, gen)
    assert state.num == 4 and out.dtype == torch.bfloat16
    assert torch.equal(out, batch.to(torch.bfloat16))  # filling: passthrough
    assert torch.equal(state.images, out)
    seen = set()
    for _ in range(8):
        state, out = tpool.pool_query_random(state, torch.randn(4, 2, 2, 1), gen)
        seen.update(float(v) for v in out.flatten())
    assert seen & {float(v) for v in batch.to(torch.bfloat16).flatten()}
