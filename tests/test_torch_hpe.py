"""mmhand_torch's HPE slice against mmhand_tpu: losses, the sigma-5 batch
preparation, the mixing dataset, the hand3d binary DB, the train step of
each variant, the trainer's resume, curriculum and plateau input, and the
tester.

Both sides start from the same weights: the port draws its nets (flax's
lecun-normal init), mmhand_tpu reads them through its own
``load_cpm_state_dict`` into an ``HPETrainState``, and the port's systems
load that state through ``convert.hpe_state_from_jax``.  Float32 on the CPU
at 32 px, batch 3.  Tolerances, as tests/test_torch_train.py holds the GAN
step: losses rtol 2e-4; parameters after Adam rtol 1e-3, atol 2e-5 on all
but 0.5% of each net's elements, and every element within 2 lr per update
(Adam's first update is lr * sign(g), so an element whose gradient is near
zero takes an update that f32 rounding decides).  Judge scores: EPE rtol
1e-4 (argmax positions of heatmaps that agree to ~1e-5), AUC atol 1e-6.

The synthetic items draw from Python's ``hash`` of their path, which is
salted per process, so every comparison of them stays in this process.
"""

import functools
import json
import os
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch import config as tcfg
from mmhand_torch.convert import cpm_state_dict_from_jax, hpe_state_from_jax
from mmhand_torch.data import build_dataset
from mmhand_torch.data import hand3d_binary as tbin
from mmhand_torch.data.rhd_tree import write_rhd_tree
from mmhand_torch.hpe import data as tdata
from mmhand_torch.hpe import system as tsys
from mmhand_torch.scripts import test_hpe as ttest
from mmhand_torch.scripts import train_hpe as ttrain
from mmhand_torch.utils.checkpoint import CheckpointManager
from mmhand_torch.utils.png import write_png
from mmhand_tpu import config as jcfg
from mmhand_tpu.data import hand3d_binary as jbin
from mmhand_tpu.eval import HPEJudge as JaxJudge
from mmhand_tpu.hpe import data as jdata
from mmhand_tpu.hpe import system as jsys
from mmhand_tpu.models import cpm as jcpm
from mmhand_tpu.ops import heatmap as jheat
from mmhand_tpu.ops.image import normalize_image as jnormalize
from test_torch_threads import two_threads  # noqa: F401

SIZE, B, LR = 32, 3, 2e-4
VARIANTS = ("hpm", "hpm2d", "hpm3d")


def _config(module, dataset="synthetic", dataroot="", ratio=1.0,
            method="MM-Hand", is_train=True, **optim):
    return module.Config(
        model=module.ModelConfig(fine_size=SIZE),
        data=module.DataConfig(dataset=dataset, dataroot=dataroot,
                               batch_size=B, augmentation_ratio=ratio,
                               augmentation_method=method),
        optim=module.OptimConfig(**optim),
        precision=module.PrecisionConfig(compute_dtype="float32"),
        is_train=is_train)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_rhd_tree(str(tmp_path_factory.mktemp("hpe") / "rhd_train"),
                          20, SIZE)


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("seed", [0, 1])
def test_smooth_l1_matches_jax(seed):
    """Both branches, the |x| = 1 seam and torch's SmoothL1Loss."""
    rng = np.random.RandomState(seed)
    pred = np.concatenate([rng.uniform(-3, 3, 200), [0.0, 1.0, -1.0, 0.5]])
    target = np.concatenate([rng.uniform(-3, 3, 200), [0.0, 0.0, 0.0, 1.5]])
    pred, target = pred.astype(np.float32), target.astype(np.float32)
    got = tsys.smooth_l1(torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsys.smooth_l1(pred, target)), rtol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), torch.nn.functional.smooth_l1_loss(
            torch.from_numpy(pred), torch.from_numpy(target),
            reduction="none").numpy(), rtol=1e-6)


@pytest.mark.parametrize("weight", [[1, 1, 1, 1], [1, 0, 1, 0], [0, 0, 0, 0],
                                    [0, 0, 0, 1]])
def test_masked_mean_matches_jax(weight):
    per = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    w = np.array(weight, np.int32)
    got = float(tsys._masked_mean(torch.from_numpy(per), torch.from_numpy(w)))
    assert got == pytest.approx(float(jsys._masked_mean(per, w)))
    assert got == (per[w == 1].mean() if w.any() else 0.0)


# --------------------------------------------------------- batch preparation

def test_prepare_batch_matches_jax_at_sigma_5():
    """Image normalization, heatmaps at sigma 5 (atol 1e-5 off the clip
    boundary, as tests/test_torch_ops.py), z and weight, against
    mmhand_tpu's jitted prepare."""
    rng = np.random.RandomState(3)
    raw = {"image": rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
           "uv": rng.uniform(-4, SIZE + 4, (B, 21, 2)).astype(np.float32),
           "z": rng.uniform(0, 1, (B, 21)).astype(np.float32),
           "weight": np.array([1, 0, 1], np.int32)}
    assert tdata.HPE_SIGMA == jdata.HPE_SIGMA == 5.0
    assert tdata.Z_SCALE == jdata.Z_SCALE == 0.7
    got = tdata.make_hpe_prepare_batch(device="cpu")(raw)
    want = jdata.make_hpe_prepare_batch()(raw)
    # one f32 ulp: inside jit, XLA divides by 255 as a multiply by the
    # reciprocal (eagerly the two agree exactly, tests/test_torch_ops.py)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                               rtol=0, atol=1.2e-7)
    np.testing.assert_array_equal(got["z"].numpy(), np.asarray(want["z"]))
    assert got["weight"].dtype == torch.int32
    np.testing.assert_array_equal(got["weight"].numpy(), raw["weight"])
    heat = got["heatmaps"].numpy()
    assert heat.shape == (B, SIZE, SIZE, 21)
    rows = np.arange(SIZE, dtype=np.float64)[:, None, None]
    cols = np.arange(SIZE, dtype=np.float64)[None, :, None]
    uv = raw["uv"].astype(np.float64)
    d2 = ((cols - uv[:, None, None, :, 0]) ** 2
          + (rows - uv[:, None, None, :, 1]) ** 2)
    exempt = np.abs(np.exp(-d2 / 50.0) - jheat.CLIP_LO) <= 1e-6
    assert exempt.mean() < 1e-3
    np.testing.assert_allclose(np.where(exempt, 0, heat),
                               np.where(exempt, 0, np.asarray(
                                   want["heatmaps"])), atol=1e-5)
    # sigma 5: the value at distance 5 is exp(-25 / 50)
    one = tdata.make_hpe_prepare_batch(device="cpu")(
        {**raw, "uv": np.full((B, 21, 2), 16.0, np.float32)})["heatmaps"]
    assert float(one[0, 16, 16, 0]) == 1.0
    assert float(one[0, 16, 21, 0]) == pytest.approx(np.exp(-0.5), abs=1e-6)


# ------------------------------------------------------------- the dataset

def _item_equal(a: dict, b: dict) -> None:
    for k in ("image", "uv", "z", "weight"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("ratio,is_train", [(1.0, True), (0.5, False)])
def test_mix_dataset_real_images_match_jax(tree, ratio, is_train):
    """The string-sorted listing, and every unmarked item: the image, uv,
    z = depth / 0.7 and weight 1."""
    port = tdata.HPEMixDataset(_config(tcfg, "RHD", tree, ratio), is_train)
    ref = jdata.HPEMixDataset(_config(jcfg, "RHD", tree, ratio), is_train)
    assert port.paths == ref.paths == sorted(port.paths)
    assert not port.augmentation_map.any() and not ref.augmentation_map.any()
    for i in range(len(port)):
        _item_equal(port.load_item(i), ref.load_item(i))
    anno = ref.annotations["color"]["3.png"]
    item = port.load_item(port.paths.index(os.path.join(tree, "color",
                                                        "3.png")))
    np.testing.assert_allclose(item["z"], anno["depth"] / 0.7, rtol=1e-6)
    batch = port.batch([0, 5, 7])
    want = ref.batch([0, 5, 7])
    for k in ("image", "uv", "z", "weight"):
        np.testing.assert_array_equal(batch[k], want[k])


def test_mix_dataset_synthetic_matches_jax():
    """The hash-seeded synthetic items (one process)."""
    port = tdata.HPEMixDataset(_config(tcfg), length_for_synthetic=6)
    ref = jdata.HPEMixDataset(_config(jcfg), length_for_synthetic=6)
    assert port.paths == ref.paths
    for i in range(6):
        _item_equal(port.load_item(i), ref.load_item(i))


def test_none_method_is_noise_with_weight_0(tree):
    """Method "None" at ratio 0: every image marked, each a noise image of
    the crop size with instance weight 0 (the ablation), labels as JAX."""
    port = tdata.HPEMixDataset(_config(tcfg, "RHD", tree, 0.0, "None"))
    ref = jdata.HPEMixDataset(_config(jcfg, "RHD", tree, 0.0, "None"))
    assert port.augmentation_map.all() and ref.augmentation_map.all()
    for i in (0, 7):
        got, want = port.load_item(i), ref.load_item(i)
        assert got["weight"] == want["weight"] == 0
        assert got["image"].shape == (SIZE, SIZE, 3)
        assert got["image"].dtype == np.uint8 and got["image"].std() > 50
        np.testing.assert_array_equal(got["uv"], want["uv"])
        np.testing.assert_array_equal(got["z"], want["z"])
    assert port.augmented_reads == 0


def _copy_fakes(tree, names, method="MM-Hand"):
    """Stand-in fakes for ``names`` in the augmentation dir: the real
    images, inverted."""
    from PIL import Image

    out = os.path.join(tdata.augmentation_dir_for(tree, method), "color")
    os.makedirs(out, exist_ok=True)
    for name in names:
        img = np.asarray(Image.open(os.path.join(tree, "color", name)))
        write_png(os.path.join(out, name), 255 - img)
    return out


def test_augmentation_map_is_what_aug_writes(tree):
    """The deliberate divergence.  aug writes the first int((1-r) N) images
    in the GAN dataset's numeric order (the target list of its split with
    is_train False).  mmhand_tpu marks a seeded random share of the
    string-sorted paths: same count, but some marked images have no fake,
    and its loader stops at them with FileNotFoundError.  The port marks
    exactly aug's images and reads every one from the augmentation dir."""
    ratio = 0.5
    written = build_dataset(_config(tcfg, "RHD", tree, ratio,
                                    is_train=False)).image_target
    assert len(written) == 10
    assert [os.path.basename(p) for p in written] == [f"{i}.png"
                                                      for i in range(10)]
    port = tdata.HPEMixDataset(_config(tcfg, "RHD", tree, ratio))
    ref = jdata.HPEMixDataset(_config(jcfg, "RHD", tree, ratio))
    port_marked = {p for p, m in zip(port.paths, port.augmentation_map) if m}
    ref_marked = {p for p, m in zip(ref.paths, ref.augmentation_map) if m}
    assert port_marked == set(written)
    assert len(ref_marked) == len(port_marked)
    missing = sorted(ref_marked - set(written))
    assert missing, "mmhand_tpu's map happens to match aug's complement"

    _copy_fakes(tree, [os.path.basename(p) for p in written])
    with pytest.raises(FileNotFoundError):
        ref.load_item(ref.paths.index(missing[0]))
    for i, marked in enumerate(port.augmentation_map):
        item = port.load_item(i)
        real = np.asarray(tdata._read_rgb(port.paths[i]))
        np.testing.assert_array_equal(item["image"],
                                      255 - real if marked else real)
        assert item["weight"] == 1
    assert port.augmented_reads == 10


def test_augmentation_map_on_a_test_leaf(tmp_path):
    """On a tree whose leaf holds 'test', the GAN dataset's split takes
    every image as a target, so aug writes them all and the port marks them
    all; at ratio 1.0 the study generates nothing and nothing is marked."""
    root = write_rhd_tree(tmp_path / "rhd_test", 12, SIZE)
    written = build_dataset(_config(tcfg, "RHD", root, 0.5,
                                    is_train=False)).image_target
    assert len(written) == 12
    port = tdata.HPEMixDataset(_config(tcfg, "RHD", root, 0.5))
    assert {p for p, m in zip(port.paths, port.augmentation_map)
            if m} == set(written)
    whole = tdata.HPEMixDataset(_config(tcfg, "RHD", root, 1.0))
    assert not whole.augmentation_map.any()


def test_update_parameters_matches_jax():
    """The curriculum hook bumps each updatable_<name> by step_<name>."""
    sides = []
    for module, cfg in ((tdata, _config(tcfg)), (jdata, _config(jcfg))):
        ds = module.HPEMixDataset(cfg, length_for_synthetic=2)
        ds.updatable_angle, ds.step_angle = 10.0, 2.5
        ds.updatable_rot_max, ds.step_rot_max = 1, 3
        for _ in range(3):
            ds.update_parameters()
        sides.append((ds.updatable_angle, ds.updatable_rot_max))
    assert sides[0] == sides[1] == (17.5, 10)


def test_hpm3d_head_is_float32_under_autocast():
    """mmhand_tpu's Hpm3d casts the depth stage's output to f32 before its
    three f32 Dense layers; under bf16 autocast the port's Linear head ran
    in bf16 until it left autocast for them."""
    net = tsys.init_lecun_normal(tsys.Hpm3d(size=SIZE),
                                 torch.Generator().manual_seed(0))
    heat = torch.from_numpy(_batch(0)["heatmaps"][:1])
    seen = []
    net.depth_fc_2.register_forward_hook(
        lambda m, args, out: seen.append((args[0].dtype, out.dtype)))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        z = net(heat)
        assert net.depth.conv1(torch.zeros(
            1, 149, 4, 4)).dtype == torch.bfloat16
    assert z.dtype == torch.float32
    assert seen == [(torch.float32, torch.float32)]


# --------------------------------------------------------- hand3d binary DB

def _bin_samples(n=3):
    rng = np.random.RandomState(4)
    return [{"image": rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8),
             "uv": rng.uniform(0, SIZE, (21, 2)).astype(np.float32),
             "xyz": rng.uniform(0.1, 0.7, (21, 3)).astype(np.float32),
             "K": np.eye(3, dtype=np.float32)} for _ in range(n)]


def test_hand3d_binary_round_trip_matches_jax(tmp_path):
    """The port's writer writes JAX's bytes, each reader reads the other's
    file, and BinDBDataset gives JAX's batches."""
    samples = _bin_samples()
    port_path, ref_path = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    assert tbin.write_gan_db(port_path, samples) == 3
    jbin.write_gan_db(ref_path, samples)
    with open(port_path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(port_path) == 3 * tbin.record_size(SIZE, SIZE)
    db = tbin.Hand3dBinaryDataset(ref_path, SIZE, SIZE)
    assert len(db) == 3
    rec = db[1]
    np.testing.assert_array_equal(rec["image"], samples[1]["image"])
    np.testing.assert_array_equal(rec["xyz"][:21], samples[1]["xyz"])
    assert not rec["xyz"][21:].any() and rec["visible"].sum() == 21
    port = tdata.BinDBDataset(port_path, size=SIZE).batch([0, 2])
    want = jdata.BinDBDataset(ref_path, size=SIZE).batch([0, 2])
    assert set(port) == set(want)
    for k in want:
        np.testing.assert_array_equal(port[k], want[k], err_msg=k)
    np.testing.assert_allclose(port["z"][0], samples[0]["xyz"][:, 2] / 0.7,
                               rtol=1e-6)


def test_hand3d_binary_rejects_a_bad_record(tmp_path):
    path = str(tmp_path / "db.bin")
    tbin.write_gan_db(path, _bin_samples(1))
    data = bytearray(open(path, "rb").read())
    sentinel = (42 * 3 + 42 * 2 + 9) * 4
    assert data[sentinel:sentinel + 2] == b"\xff\xff"
    data[sentinel] = 0
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="sentinel"):
        tbin.Hand3dBinaryDataset(path, SIZE, SIZE)[0]
    open(path, "wb").write(bytes(data[:100]))
    with open(path, "rb") as fh, pytest.raises(ValueError, match="truncated"):
        tbin.read_record(fh, SIZE, SIZE)


# --------------------------------------------------------- the train step

@functools.lru_cache(maxsize=None)
def _weights():
    """The port's initial nets at 32 px (drawn as flax draws them) and the
    same weights as mmhand_tpu variables."""
    system = tsys.HPESystem(_config(tcfg), "hpm", "cpu")
    sds = {name: {k: v.detach().clone() for k, v in
                  getattr(system, name).state_dict().items()}
           for name in ("hpm2d", "hpm3d")}
    return sds, {name: jcpm.load_cpm_state_dict(sd)["params"]
                 for name, sd in sds.items()}


def _jax_state(variant):
    params = _weights()[1]
    system = jsys.HPESystem(dtype=jnp.float32, variant=variant)
    p2d = params["hpm2d"] if variant in ("hpm", "hpm2d") else None
    p3d = params["hpm3d"] if variant in ("hpm", "hpm3d") else None
    return system, jsys.HPETrainState(
        step=jnp.zeros((), jnp.int32), params2d=p2d, params3d=p3d,
        opt2d=None if p2d is None else system.tx.init(p2d),
        opt3d=None if p3d is None else system.tx.init(p3d))


@functools.lru_cache(maxsize=None)
def _jax_step(variant):
    """One jit per variant, shared by the tests of this file."""
    return jax.jit(jsys.make_hpe_train_step(_jax_state(variant)[0]))


def _port_system(variant, state):
    """A port system of ``variant`` holding ``state``'s weights."""
    system = tsys.HPESystem(_config(tcfg), variant, "cpu")
    converted = hpe_state_from_jax(state)
    assert converted["step"] == int(state.step)
    for name in ("hpm2d", "hpm3d"):
        net = getattr(system, name)
        assert (net is None) == (converted[name] is None)
        if net is not None:
            net.load_state_dict(converted[name])
    return system


def _batch(seed, weight=(1, 1, 1)):
    rng = np.random.RandomState(seed)
    return {"image": rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
            "heatmaps": rng.uniform(0, 1, (B, SIZE, SIZE, 21)).astype(
                np.float32),
            "z": rng.uniform(0, 1.4, (B, 21)).astype(np.float32),
            "weight": np.asarray(weight, np.int32)}


def _assert_nets_close(system, state, updates):
    want = hpe_state_from_jax(state)
    for name in ("hpm2d", "hpm3d"):
        if want[name] is None:
            continue
        got = getattr(system, name).state_dict()
        assert set(got) == set(want[name])
        outside = total = 0
        for k, v in want[name].items():
            a, b = got[k].detach().numpy(), v.numpy()
            diff = np.abs(a - b)
            outside += int((diff > 2e-5 + 1e-3 * np.abs(b)).sum())
            total += b.size
            assert diff.max() <= 2 * LR * updates, \
                f"{name}.{k} differs by {diff.max()}"
        assert outside <= 0.005 * total, \
            f"{name}: {outside} of {total} elements differ"


def test_hpe_state_from_jax_round_trips_the_port_weights():
    sds, _ = _weights()
    _, state = _jax_state("hpm")
    converted = hpe_state_from_jax(state)
    for name, sd in sds.items():
        assert set(converted[name]) == set(sd)
        for k, v in sd.items():
            assert torch.equal(converted[name][k], v), f"{name}.{k}"
    assert hpe_state_from_jax(_jax_state("hpm3d")[1])["hpm2d"] is None


def test_init_draws_flax_lecun_normal():
    """Kernels: standard deviation 1/sqrt(fan_in) within 2%, truncated at
    2 / 0.8796 of it; biases 0; the same draw from the same seed."""
    sds, _ = _weights()
    for name, fan_in in (("conv4_2.weight", 512 * 9),
                         ("stage3.conv2.weight", 128 * 49)):
        w = sds["hpm2d"][name]
        std = 1.0 / np.sqrt(fan_in)
        assert abs(float(w.std()) / std - 1) < 0.02
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 * 1.0001
    w = sds["hpm3d"]["depth_fc_1.weight"]
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1) < 0.02
    assert not any(v.any() for k, v in sds["hpm3d"].items()
                   if k.endswith("bias"))
    again = tsys.HPESystem(_config(tcfg), "hpm", "cpu").hpm3d.state_dict()
    assert all(torch.equal(again[k], v) for k, v in sds["hpm3d"].items())


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_matches_jax_over_three_steps(variant):
    """Losses every step, then every parameter after three Adam updates;
    the second batch masks one sample (instance weight 0)."""
    jsystem, state = _jax_state(variant)
    step = _jax_step(variant)
    system = _port_system(variant, state)
    port_step = tsys.make_hpe_train_step(system)
    keys = {"hpm": {"mse", "lz"}, "hpm2d": {"mse"}, "hpm3d": {"lz"}}[variant]
    for i, weight in enumerate([(1, 1, 1), (1, 0, 1), (1, 1, 1)]):
        b = _batch(10 + i, weight)
        state, want = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                           LR)
        got = port_step({k: torch.from_numpy(v) for k, v in b.items()}, LR)
        assert set(got) == set(want) == keys
        for k in keys:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=2e-4, err_msg=f"step {i} {k}")
    assert system.step == int(state.step) == 3
    _assert_nets_close(system, state, 3)


@pytest.mark.parametrize("variant", VARIANTS)
def test_first_step_gradients_match_jax(variant):
    """Every parameter's gradient of the first step, leaf by leaf, against
    mmhand_tpu's (twice Adam's first moment after one step, which is
    (1 - 0.5) g): the norm of the difference within 1e-2 of the leaf's
    norm, at any scale.  The check after three steps cannot see a leaf
    whose gradient lies far below Adam's eps, as in Hpm3d's chain of CPM
    stages: the update lr * g / (|g| + eps) leaves its f32 weights as they
    were in both packages.  This one can; a missing or detached path gives
    a difference of 1.  Every leaf agrees within 5e-6 of its norm but
    Hpm3d's conv6_1_CPM, within 2e-3: one of its ReLU's inputs lies within
    1e-6 of 0 (their largest 7e-3), where the packages' masks may differ."""
    _, state = _jax_state(variant)
    system = _port_system(variant, state)
    b = _batch(10)
    state, _ = _jax_step(variant)(
        state, {k: jnp.asarray(v) for k, v in b.items()}, LR)
    tsys.make_hpe_train_step(system)(
        {k: torch.from_numpy(v) for k, v in b.items()}, LR)
    smallest = {}
    for name, opt in (("hpm2d", state.opt2d), ("hpm3d", state.opt3d)):
        if opt is None:
            continue
        want = cpm_state_dict_from_jax(
            {"params": jax.tree.map(lambda m: 2 * m, opt[0].mu)})
        got = dict(getattr(system, name).named_parameters())
        assert set(got) == set(want)
        for k, p in got.items():
            assert p.grad is not None, f"{name}.{k} has no gradient"
            a, g = p.grad.numpy(), want[k].numpy()
            assert np.linalg.norm(a - g) <= 1e-2 * np.linalg.norm(g), \
                f"{name}.{k}: |g| {np.linalg.norm(g)}, " \
                f"|diff| {np.linalg.norm(a - g)}"
        smallest[name] = min(float(np.abs(v.numpy()).max())
                             for k, v in want.items()
                             if k.endswith("weight"))
    if variant != "hpm2d":
        # the case this test is for is present at this size
        assert smallest["hpm3d"] < 1e-8, smallest


@pytest.mark.parametrize("variant", VARIANTS)
def test_all_zero_weight_batch_changes_nothing(variant):
    """Every sample masked: both sides' losses are 0 and Adam's first
    update is 0, so no parameter moves."""
    _, state = _jax_state(variant)
    system = _port_system(variant, state)
    before = hpe_state_from_jax(state)
    b = _batch(20, (0, 0, 0))
    state, want = _jax_step(variant)(
        state, {k: jnp.asarray(v) for k, v in b.items()}, LR)
    got = tsys.make_hpe_train_step(system)(
        {k: torch.from_numpy(v) for k, v in b.items()}, LR)
    assert all(float(v) == 0.0 for v in list(got.values())
               + list(want.values()))
    for name in ("hpm2d", "hpm3d"):
        if before[name] is None:
            continue
        now = getattr(system, name).state_dict()
        assert all(torch.equal(now[k], v) for k, v in before[name].items())


# ------------------------------------------------------------ the trainer

@pytest.fixture
def ckpt(tmp_path):
    """A checkpoint root, removed after the test: an HPE state file holds
    ~78 M parameters and two Adam moments, 0.5-0.9 GB at any --fineSize."""
    yield tmp_path / "ckpt"
    shutil.rmtree(tmp_path / "ckpt", ignore_errors=True)


def _argv(ckpt, name, *extra):
    return ["--device", "cpu", "--dataset", "synthetic", "--fineSize",
            str(SIZE), "--batchSize", "2", "--checkpoints_dir", str(ckpt),
            "--name", name, "--seed", "5", *extra]


def test_train_hpe_resume_equals_an_unbroken_run(ckpt, capsys):
    """2 steps, then 2 more with --continue_train from epoch 2, equal 4
    unbroken steps bit for bit: both nets, both Adams and the step (2 steps
    per epoch; the resumed run restarts its epochs at --epoch_count)."""
    common = ["--max_dataset_size", "4", "--print_freq", "1",
              "--save_epoch_freq", "10"]
    whole = ttrain.main(_argv(ckpt, "whole", *common, "--max_steps", "4"))
    shutil.rmtree(ckpt / "whole")
    ttrain.main(_argv(ckpt, "split", *common, "--max_steps", "2"))
    path = CheckpointManager(str(ckpt), "split").path("latest")
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 2 and saved["variant"] == "hpm"
    assert saved["opt2d"]["state"] and saved["opt3d"]["state"]
    resumed = ttrain.main(_argv(ckpt, "split", *common, "--max_steps", "2",
                                "--continue_train", "--epoch_count", "2"))
    out = capsys.readouterr().out
    assert out.count("(epoch: 2, iters: ") == 4  # 2 unbroken, 2 resumed
    assert resumed.system.step == whole.system.step == 4
    a, b = whole.system.state_dict(), resumed.system.state_dict()
    for name in ("hpm2d", "hpm3d"):
        assert all(torch.equal(a[name][k], b[name][k]) for k in a[name])
    for name in ("opt2d", "opt3d"):
        for i, st in a[name]["state"].items():
            assert all(torch.equal(v, b[name]["state"][i][k])
                       for k, v in st.items())
    assert resumed.last_metrics == whole.last_metrics
    assert set(whole.last_metrics) == {"mse", "lz"}


def test_train_hpe_curriculum_and_plateau_input(ckpt, monkeypatch):
    """--model hpm3d, one step per epoch for 10 epochs: the curriculum hook
    runs after epochs 5 and 10, every save_epoch_freq epoch is saved, and
    the plateau schedule reads each epoch's mean lz."""
    calls, seen = [], []
    monkeypatch.setattr(tdata.HPEMixDataset, "update_parameters",
                        lambda self: calls.append(1))
    real = ttrain.LRSchedule.epoch_lr

    def spy(self, epoch, metric=None):
        seen.append(metric)
        return real(self, epoch, metric)

    monkeypatch.setattr(ttrain.LRSchedule, "epoch_lr", spy)
    losses = []
    step = tsys.make_hpe_train_step

    def recording(system):
        inner = step(system)

        def run(batch, lr):
            m = inner(batch, lr)
            losses.append(float(m["lz"]))
            return m

        return run

    monkeypatch.setattr(ttrain, "make_hpe_train_step", recording)
    result = ttrain.train_hpe(
        _config(tcfg, lr_policy="plateau").replace(
            data=tcfg.DataConfig(dataset="synthetic", batch_size=2,
                                 max_dataset_size=2),
            run=tcfg.RunConfig(checkpoints_dir=str(ckpt), name="cur",
                               save_epoch_freq=5)),
        epochs=10, variant="hpm3d", device="cpu")
    assert result.steps == 10 and set(result.last_metrics) == {"lz"}
    assert len(calls) == 2
    assert seen[0] is None
    np.testing.assert_allclose(seen[1:], losses[:9], rtol=1e-6)
    labels = CheckpointManager(str(ckpt), "cur").available_labels()
    assert labels == ["10", "5", "latest"]
    with open(ckpt / "cur" / "lr_sched.json") as fh:
        assert set(json.load(fh)) == {"lr", "best", "num_bad"}


def test_train_hpe_cli_runs_each_variant(ckpt, capsys):
    """The command line at 32 px, 2 steps, each --model: its checkpoint
    holds that variant's nets only."""
    for variant in VARIANTS:
        result = ttrain.main(_argv(ckpt, variant, "--max_steps", "2",
                                   "--model", variant))
        assert result.steps == 2
        saved = torch.load(CheckpointManager(str(ckpt), variant).path(
            "latest"), weights_only=True)
        assert (saved["hpm2d"] is None) == (variant == "hpm3d")
        assert (saved["hpm3d"] is None) == (variant == "hpm2d")
    out = capsys.readouterr().out
    assert out.count("done: 2 steps") == 3
    with pytest.raises(ValueError, match="variant"):
        tsys.HPESystem(_config(tcfg), "hpm4d", "cpu")


def test_train_hpe_from_bin(ckpt, tmp_path):
    """--from_bin: the batches come from a hand3d packed binary DB, every
    sample of weight 1; one hpm3d step, its state saved."""
    path = str(tmp_path / "db.bin")
    tbin.write_gan_db(path, _bin_samples(4))
    cfg = _config(tcfg).replace(run=tcfg.RunConfig(
        checkpoints_dir=str(ckpt), name="bin", print_freq=1))
    result = ttrain.train_hpe(cfg, max_steps=1, from_bin=path,
                              variant="hpm3d", device="cpu")
    assert result.steps == 1 and result.augmented_reads == 0
    assert np.isfinite(result.last_metrics["lz"])
    assert CheckpointManager(str(ckpt), "bin").has("latest")


def test_train_hpe_two_ranks_equal_the_full_batch(ckpt):
    """--multihost over gloo: 2 ranks of batch 2 against one process of
    batch 4 on the same 4 items (PYTHONHASHSEED fixed, so the synthetic
    items agree across processes).  The gradients averaged over the ranks
    are the full batch's, so both nets end within the train step's bound
    and the losses agree; the checkpoint holds both nets."""
    from mmhand_torch.parallel.dryrun import launch

    env = {"OMP_NUM_THREADS": "1", "PYTHONHASHSEED": "0",
           "PYTHONPATH": str(Path(__file__).resolve().parent.parent)}
    argv = ["-m", "mmhand_torch.scripts.train_hpe", "--device", "cpu",
            "--dataset", "synthetic", "--fineSize", str(SIZE),
            "--batchSize", "4", "--max_dataset_size", "4", "--max_steps", "1",
            "--checkpoints_dir", str(ckpt), "--seed", "5"]
    logs = launch(argv + ["--multihost", "--name", "dp"], 2, timeout=180,
                  env=env)
    logs += launch(argv + ["--name", "one"], 1, timeout=180, env=env)
    done = [re.search(r"done: 1 steps, mse=(\S+) lz=(\S+);", log)
            for log in (logs[0], logs[2])]
    assert "done:" not in logs[1] and all(done)
    np.testing.assert_allclose([float(v) for v in done[0].groups()],
                               [float(v) for v in done[1].groups()],
                               rtol=2e-4)
    states = [torch.load(CheckpointManager(str(ckpt), name).path("latest"),
                         weights_only=True) for name in ("dp", "one")]
    assert states[0]["step"] == states[1]["step"] == 1
    for name in ("hpm2d", "hpm3d"):
        outside = total = 0
        for k, b in states[1][name].items():
            diff = (states[0][name][k] - b).abs()
            outside += int((diff > 2e-5 + 1e-3 * b.abs()).sum())
            total += b.numel()
            assert float(diff.max()) <= 2 * LR, f"{name}.{k}"
        assert outside <= 0.005 * total, f"{name}: {outside} of {total}"


# ------------------------------------------------------------- the tester

@pytest.fixture(scope="module")
def tested(tree, tmp_path_factory):
    """A port checkpoint of the shared weights (the JAX state's, through
    hpe_state_from_jax) and the JAX judge's inputs over the test tree."""
    ckpt = tmp_path_factory.mktemp("test_hpe")
    _, state = _jax_state("hpm")
    system = _port_system("hpm", state)
    CheckpointManager(str(ckpt), "run").save(system, "latest")
    ref = jdata.HPEMixDataset(_config(jcfg, "RHD", tree, is_train=False),
                              is_train=False)
    raws = [ref.batch(range(i, min(i + 8, len(ref))))
            for i in range(0, len(ref), 8)]
    yield ckpt, state, raws
    shutil.rmtree(ckpt, ignore_errors=True)


def _port_scores(ckpt, tree, variant, capsys):
    results = ttest.main(["--device", "cpu", "--dataset", "RHD",
                          "--dataroot", tree, "--fineSize", str(SIZE),
                          "--checkpoints_dir", str(ckpt), "--name", "run",
                          "--model", variant])
    return results, capsys.readouterr().out


def test_test_hpe_matches_jax_judge(tested, tree, capsys):
    """``--model hpm`` and ``hpm2d`` on the same weights and test tree as
    mmhand_tpu's HPEJudge, fed as scripts/test_hpe.py feeds it."""
    ckpt, state, raws = tested
    judge = JaxJudge({"params": state.params2d}, {"params": state.params3d})
    for raw in raws:
        xyz = np.concatenate([raw["uv"], (raw["z"] * 700.0)[:, :, None]], -1)
        judge.feed(np.asarray(jnormalize(raw["image"])), xyz)
    r2d, r3d = judge.get_results(30, 20)
    results, out = _port_scores(ckpt, tree, "hpm", capsys)
    assert set(results) == {"2d", "3d"} and "## 3d ##" in out
    for tag, r in (("2d", r2d), ("3d", r3d)):
        got = results[tag]
        np.testing.assert_allclose([got["epe_mean"], got["epe_median"]],
                                   [r[0], r[1]], rtol=1e-4, err_msg=tag)
        assert got["auc"] == pytest.approx(r[2], abs=1e-6)
    only2d, out = _port_scores(ckpt, tree, "hpm2d", capsys)
    assert set(only2d) == {"2d"} and "3d" not in out
    assert only2d["2d"] == results["2d"]


def test_test_hpe_z_error_scales_by_fine_size(tested, tree, capsys):
    """``--model hpm3d``: |z - z_gt| on the ground-truth heatmaps, times
    --fineSize (32 here); scripts/test_hpe.py multiplies by a literal 256,
    8 times the port's value at this size."""
    ckpt, state, raws = tested
    prepare = jdata.make_hpe_prepare_batch()
    net = jcpm.Hpm3d(dtype=jnp.float32)
    errs = []
    for raw in raws:
        batch = prepare(raw)
        z = np.asarray(net.apply({"params": state.params3d},
                                 batch["heatmaps"]))
        errs.append(np.abs(z - np.asarray(batch["z"])) * 256.0)
    jax_256 = np.concatenate(errs, 0)
    results, out = _port_scores(ckpt, tree, "hpm3d", capsys)
    assert "3d (z only)" in out
    got = results["3d_z"]
    np.testing.assert_allclose(
        [got["epe_mean"], got["epe_median"]],
        [np.mean(jax_256) * SIZE / 256, np.median(jax_256) * SIZE / 256],
        rtol=1e-4)
