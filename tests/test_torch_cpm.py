"""The port's CPM judge nets (Hpm2d, Hpm3d) and HPEJudge against mmhand_tpu.

Both sides get the same weights through the npz path a converted reference
checkpoint takes: the port's random nets are saved as npz dumps of their
state_dicts (with DataParallel's ``module.`` prefix) and read by
mmhand_tpu's ``load_cpm_npz``.  Float32 on the CPU at 64 px; heatmaps and z
at rtol/atol 1e-4 (conv taps summed in another order over 27 and 34
convolutions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch.convert import cpm_state_dict_from_jax
from mmhand_torch.eval import HPEJudge as TorchJudge
from mmhand_torch.models import cpm as tcpm
from mmhand_torch.models.inception import init_fan_in
from mmhand_tpu.eval import HPEJudge as JaxJudge
from mmhand_tpu.models import cpm as jcpm

SIZE = 64


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    gen = torch.Generator().manual_seed(0)
    t2 = init_fan_in(tcpm.Hpm2d(), gen).eval()
    t3 = init_fan_in(tcpm.Hpm3d(size=SIZE), gen).eval()
    root = tmp_path_factory.mktemp("cpm")
    paths = []
    for name, net in (("hpm2d", t2), ("hpm3d", t3)):
        path = str(root / f"{name}.npz")
        np.savez(path, **{f"module.{k}": v.numpy()
                          for k, v in net.state_dict().items()})
        paths.append(path)
    v2, v3 = (jcpm.load_cpm_npz(p) for p in paths)
    judge = JaxJudge(v2, v3)  # float32 by default
    return t2, t3, v2, v3, judge, paths


def _images(seed, batch=2):
    return np.random.RandomState(seed).uniform(
        -1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)


def test_hpm2d_and_hpm3d_match_jax(nets):
    t2, t3, v2, v3, _, _ = nets
    x = _images(1)
    fwd = jax.jit(lambda a, b, x: (lambda heat: (heat, jcpm.Hpm3d(
        dtype=jnp.float32).apply(b, heat[-1])))(
            jcpm.Hpm2d(dtype=jnp.float32).apply(a, x)))
    want_heat, want_z = fwd(v2, v3, x)
    with torch.no_grad():
        heat = t2(torch.from_numpy(x))
        z = t3(heat[-1])
    assert len(heat) == 6
    for got, want in zip(heat, want_heat):
        assert got.shape == (2, SIZE, SIZE, 21)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    assert z.shape == (2, 21)
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z),
                               rtol=1e-4, atol=1e-4)


def test_parameter_counts():
    """The reference nets at 256 px (net_hpm2d.py, net_hpm3d.py): built
    only, no forward."""
    assert sum(p.numel() for p in tcpm.Hpm2d().parameters()) == 36_799_806
    assert sum(p.numel() for p in tcpm.Hpm3d(size=256).parameters()) == 52_259_816


def test_npz_round_trip(nets):
    t2, t3, v2, v3, _, paths = nets
    for net, variables, path in ((t2, v2, paths[0]), (t3, v3, paths[1])):
        want = net.state_dict()
        loaded = tcpm.load_cpm_npz(path)
        assert set(loaded) == set(want)
        back = cpm_state_dict_from_jax(variables)
        assert set(back) == set(want)
        for k, v in back.items():
            assert torch.equal(v, want[k]) and torch.equal(loaded[k], want[k]), k


def test_judge_decode_matches_jax(nets):
    """x, y equal to mmhand_tpu's argmax decode, except where the last
    stage's heatmap has a near-tie: a keypoint whose port argmax lies within
    1e-5 of the JAX maximum under the JAX heatmap.  There are at most 2 of
    the 84 keypoints; z at rtol/atol 1e-4 (times H)."""
    t2, t3, v2, v3, judge, _ = nets
    images = _images(2, batch=4)
    jx, jy, jz = (np.asarray(a) for a in judge._predict(v2, v3, images))
    port = TorchJudge(t2, t3, device="cpu")
    x, y, z = (t.numpy() for t in port.predict(torch.from_numpy(images)))
    heat = np.asarray(jcpm.Hpm2d(dtype=jnp.float32).apply(v2, images)[-1])
    differ = (x != jx) | (y != jy)
    for b, k in zip(*np.nonzero(differ)):
        top = heat[b, :, :, k].max()
        assert top - heat[b, int(y[b, k]), int(x[b, k]), k] <= 1e-5
    assert differ.sum() <= 2
    np.testing.assert_allclose(z, jz, rtol=1e-4, atol=1e-4 * SIZE)
    assert len(np.unique(x * SIZE + y)) > 10  # not one location for all


def test_judge_feed_matches_jax(nets):
    """The EvalUtil accumulation over one batch gives JAX's PCK AUCs."""
    t2, t3, _, _, judge, _ = nets
    images = _images(3)
    rng = np.random.RandomState(4)
    gt = np.concatenate([rng.uniform(0, SIZE, (2, 21, 2)),
                         rng.uniform(300, 700, (2, 21, 1))], -1)
    port = TorchJudge(t2, t3, device="cpu")
    port.feed(torch.from_numpy(images), gt)
    judge.eval2d.data = [[] for _ in range(21)]
    judge.eval3d.data = [[] for _ in range(21)]
    judge.feed(images, gt)
    got, want = port.get_results(), judge.get_results()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[:3], w[:3], rtol=1e-4, atol=1e-4)


def test_random_judge_warns():
    with pytest.warns(UserWarning, match="RANDOM CPM"):
        judge = TorchJudge.random_init(size=32, device="cpu")
    assert judge.random_weights
    assert judge.hpm3d.depth_fc_1.in_features == 21 * 4 * 4
