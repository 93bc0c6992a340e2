"""The port's hand3d scripts against mmhand_tpu's on the CPU at 32 px:
train_hand3d, eval_hand3d (its EPE and AUC in all three modes),
create_hand3d_db, run_hand3d, handpose_judge and the ratio driver's hand3d
stages.

Both sides get the same weights: mmhand_tpu's scripts draw theirs from
PRNGKey(0) when they find no checkpoint, and the port reads the same
parameters, converted by ``convert.hand3d_state_dict_from_jax``, from the
checkpoints it writes (``<name>_<net>`` and ``<name>_full``).  mmhand_tpu's
eval_hand3d (--mode full) and handpose_judge build ColorHandPose3D at
crop 256 whatever the image size; the tests build it at crop 32 on both
sides.  Tolerances: EPE rtol 1e-4, AUC atol 1e-6 (as
tests/test_torch_hpe.py); the 3D coordinates of the demos atol 2e-5 (the
net's 1e-5 plus the JSON's rounding to 5 decimals), the landmarks of the
judge atol 1e-4 after its rounding to 4; the crop's scale and centre
exactly.

mmhand_tpu's scripts switch JAX to the rbg PRNG when imported unless
MMHAND_STRICT_PRNG=1, which the tests set, so later tests in the worker
keep threefry.
"""

import functools
import importlib
import json
import math
import re
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch.convert import hand3d_state_dict_from_jax
from mmhand_torch.data.rhd_tree import write_rhd_tree
from mmhand_torch.hand3d import Hand3DSystem
from mmhand_torch.hpe.data import augmentation_dir_for
from mmhand_torch.models.cpm import Hpm2d, Hpm3d
from mmhand_torch.models.inception import init_fan_in
from mmhand_torch.scripts import create_hand3d_db as tdb
from mmhand_torch.scripts import eval_hand3d as teval
from mmhand_torch.scripts import handpose_judge as tjudge
from mmhand_torch.scripts import mm_train_ratio
from mmhand_torch.scripts import run_hand3d as trun
from mmhand_torch.scripts import train_hand3d as ttrain
from mmhand_torch.utils.checkpoint import CheckpointManager
from mmhand_tpu.hand3d import system as jsys
from mmhand_tpu.models import hand3d as jnet
from test_torch_threads import two_threads  # noqa: F401

SIZE = 32
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def jax_script(monkeypatch):
    """scripts/<name>.py of mmhand_tpu, threefry kept."""
    monkeypatch.setenv("MMHAND_STRICT_PRNG", "1")

    def load(name):
        return importlib.import_module(f"scripts.{name}")

    return load


@pytest.fixture
def ckpt(tmp_path):
    yield tmp_path / "ckpt"
    shutil.rmtree(tmp_path / "ckpt", ignore_errors=True)


# ----------------------------------------------------------- train_hand3d

def test_record_helpers_match_jax(jax_script):
    """synthetic_records, records_to_pipeline_batch and each net's reader
    flags."""
    jtrain = jax_script("train_hand3d")
    got, want = ttrain.synthetic_records(3, SIZE, 4), \
        jtrain.synthetic_records(3, SIZE, 4)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    got, want = (ttrain.records_to_pipeline_batch(got),
                 jtrain.records_to_pipeline_batch(want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for net in ("handsegnet", "posenet", "lifting"):
        port = ttrain.pipeline_config_for(net, (SIZE, SIZE), 16)
        ref = jtrain.pipeline_config_for(net, (SIZE, SIZE),
                                         SimpleNamespace(crop_size=16))
        assert vars(port) == vars(ref), net


def _train_argv(ckpt, net, *extra):
    return ["--net", net, "--device", "cpu", "--image_size", str(SIZE),
            "--crop_size", str(SIZE), "--batch_size", "2",
            "--checkpoints_dir", str(ckpt), "--name", "t", *extra]


@pytest.mark.parametrize("net", ["handsegnet", "posenet", "lifting"])
def test_train_hand3d_cli_trains_and_saves(ckpt, net, capsys):
    """Two iterations on synthetic records: mmhand_tpu's lines, finite
    positive losses, the state at <name>_<net>/state_latest.pt."""
    result = ttrain.main(_train_argv(ckpt, net, "--max_iter", "2"))
    out = capsys.readouterr().out
    assert re.search(r"^Iteration 0\t Loss \S+\t \(\d+\.\ds\)$", out, re.M)
    assert re.search(r"^Training finished after 2 iterations; final loss "
                     r"\S+$", out, re.M)
    assert len(result.losses) == 2
    assert all(math.isfinite(v) and v > 0 for v in result.losses)
    saved = torch.load(ckpt / f"t_{net}" / "state_latest.pt",
                       weights_only=True)
    assert saved["step"] == 2 and saved["net"] == net
    assert saved["opt"]["state"]


def test_train_hand3d_continue_train(ckpt, capsys):
    """--continue_train resumes the net, the Adam and the step; the loop
    runs from the saved step to --max_iter."""
    first = ttrain.main(_train_argv(ckpt, "lifting", "--max_iter", "2"))
    resumed = ttrain.main(_train_argv(ckpt, "lifting", "--max_iter", "3",
                                      "--continue_train"))
    out = capsys.readouterr().out
    assert "resumed at step 2" in out
    assert resumed.system.step == 3 and len(resumed.losses) == 1
    opt = resumed.system.opt.state_dict()["state"]
    assert all(int(s["step"]) == 3 for s in opt.values())
    assert first.system.step == 2


# ------------------------------------------------------------ eval_hand3d

@functools.lru_cache(maxsize=None)
def _jax_params(net, variant="proposed"):
    """mmhand_tpu's eval_hand3d weights without a checkpoint: init_state
    from PRNGKey(0) at the image size."""
    system = jsys.Hand3DSystem(net=net, variant=variant, crop_size=SIZE)
    return jax.jit(system.init_state, static_argnums=1)(
        jax.random.PRNGKey(0), (SIZE, SIZE)).params


@functools.lru_cache(maxsize=None)
def _jax_full_params():
    """mmhand_tpu's ColorHandPose3D weights without a checkpoint."""
    net = jnet.ColorHandPose3D(crop_size=SIZE)
    return jax.jit(net.init)({"params": jax.random.PRNGKey(0)},
                             jnp.zeros((1, SIZE, SIZE, 3)),
                             jnp.zeros((1, 2)))["params"]


def _save_subnet(ckpt, name, net, params):
    system = Hand3DSystem(net, crop_size=SIZE, device="cpu")
    system.module.load_state_dict(hand3d_state_dict_from_jax(params))
    CheckpointManager(str(ckpt), f"{name}_{net}").save(system, "latest")


def _save_full(ckpt, name, params):
    path = ckpt / f"{name}_full" / "state_latest.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"module": hand3d_state_dict_from_jax(params)}, path)


@pytest.mark.parametrize("mode", ["2d", "3d", "full"])
def test_eval_hand3d_matches_jax(ckpt, jax_script, monkeypatch, mode,
                                 capsys):
    """EPE and AUC of each mode on the same weights and synthetic records
    as mmhand_tpu's script, which finds no checkpoint and draws its own."""
    jeval = jax_script("eval_hand3d")
    monkeypatch.setattr(jeval, "ColorHandPose3D",
                        functools.partial(jnet.ColorHandPose3D,
                                          crop_size=SIZE))
    if mode == "2d":
        _save_subnet(ckpt, "e", "posenet", _jax_params("posenet"))
    elif mode == "3d":
        _save_subnet(ckpt, "e", "lifting", _jax_params("lifting"))
    else:
        _save_full(ckpt, "e", _jax_full_params())
    common = ["--mode", mode, "--image_size", str(SIZE), "--crop_size",
              str(SIZE), "--batch_size", "4", "--name", "e"]
    got = teval.main(common + ["--device", "cpu",
                               "--checkpoints_dir", str(ckpt)])
    want = jeval.main(common + ["--checkpoints_dir",
                                str(ckpt.parent / "none")])
    np.testing.assert_allclose([got["mean"], got["median"]],
                               [want["mean"], want["median"]], rtol=1e-4)
    assert got["auc"] == pytest.approx(want["auc"], abs=1e-6)
    out = capsys.readouterr().out
    unit = "pixels" if mode == "2d" else "mm"
    assert out.count(f"Evaluation results ({mode}):") == 2
    assert out.count(f"Average mean EPE: ") == 2 and unit in out


# -------------------------------------------------------- create_hand3d_db

def test_create_hand3d_db_writes_jax_bytes(tmp_path, jax_script, capsys):
    """Over a crop tree and over an image directory that holds only some
    of its images (aug's output): the same records, byte for byte."""
    tree = write_rhd_tree(tmp_path / "rhd_train", 6, SIZE, seed=3)
    images = Path(augmentation_dir_for(tree, "MM-Hand"))
    (images / "color").mkdir(parents=True)
    for i in (0, 3, 5):
        shutil.copy(Path(tree) / "color" / f"{i}.png", images / "color")
    jdb = jax_script("create_hand3d_db")
    for extra, n in (([], 6), (["--images", str(images)], 3)):
        port, ref = tmp_path / "port.bin", tmp_path / "jax.bin"
        assert tdb.main(["--dataroot", tree, "--out", str(port),
                         *extra]) == n
        jdb.main(["--dataroot", tree, "--out", str(ref), *extra])
        assert port.read_bytes() == ref.read_bytes()
    assert f"wrote 3 records to {port}" in capsys.readouterr().out


# --------------------------------------------------- run_hand3d and judge

def _pngs(tmp_path, n=2):
    rng = np.random.RandomState(5)
    from PIL import Image

    paths = []
    for i in range(n):
        path = tmp_path / f"img{i}.png"
        Image.fromarray(rng.randint(0, 256, (40, 48, 3)).astype(
            np.uint8)).save(path)
        paths.append(str(path))
    return paths


def test_run_hand3d_matches_jax(tmp_path, ckpt, jax_script):
    """The overlay PNG and the coordinates JSON of each image, on the
    weights mmhand_tpu's demo draws."""
    _save_full(ckpt, "d", _jax_full_params())
    images = _pngs(tmp_path)
    common = ["--size", str(SIZE), "--crop_size", str(SIZE), "--name", "d"]
    trun.main(images + common + ["--device", "cpu", "--out_dir",
                                 str(tmp_path / "port"),
                                 "--checkpoints_dir", str(ckpt)])
    jax_script("run_hand3d").main(images + common + [
        "--out_dir", str(tmp_path / "jax")])
    for stem in ("img0", "img1"):
        got = json.loads((tmp_path / "port" / f"{stem}_coord3d.json")
                         .read_text())
        want = json.loads((tmp_path / "jax" / f"{stem}_coord3d.json")
                          .read_text())
        assert set(got) == set(want)
        np.testing.assert_allclose(got["keypoint_coord3d"],
                                   want["keypoint_coord3d"], atol=2e-5)
        assert got["scale"] == pytest.approx(want["scale"], rel=1e-6)
        assert got["center"] == want["center"]
        png = tmp_path / "port" / f"{stem}_crop_kp.png"
        assert png.stat().st_size > 0


def test_run_hand3d_warns_without_a_checkpoint(tmp_path, ckpt):
    with pytest.warns(UserWarning, match="RANDOM weights"):
        trun.main(_pngs(tmp_path, 1) + [
            "--size", str(SIZE), "--crop_size", str(SIZE), "--device",
            "cpu", "--out_dir", str(tmp_path / "out"),
            "--checkpoints_dir", str(ckpt)])


def test_handpose_judge_hand3d_matches_jax(tmp_path, ckpt, jax_script,
                                           monkeypatch):
    """ColorHandPose3D's landmarks in the image's frame, at crop 32 on
    both sides."""
    jjudge = jax_script("handpose_judge")
    monkeypatch.setattr(jnet, "ColorHandPose3D",
                        functools.partial(jnet.ColorHandPose3D,
                                          crop_size=SIZE))
    images = np.stack([jjudge.load_tensor(p, SIZE)
                       for p in _pngs(tmp_path)])
    _save_full(ckpt, "hand3d", _jax_full_params())
    got = tjudge.estimate_hands_hand3d(images, str(ckpt), device="cpu",
                                       crop_size=SIZE)
    want = jjudge.estimate_hands_hand3d(images)
    assert got.shape == want.shape == (2, 21, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_handpose_judge_cpm_matches_jax(tmp_path, jax_script):
    """The CPM judge on the same npz weights."""
    gen = torch.Generator().manual_seed(0)
    paths = {}
    for name, net in (("hpm2d", Hpm2d()), ("hpm3d", Hpm3d(size=SIZE))):
        init_fan_in(net, gen)
        paths[name] = str(tmp_path / f"{name}.npz")
        np.savez(paths[name], **{k: v.numpy()
                                 for k, v in net.state_dict().items()})
    jjudge = jax_script("handpose_judge")
    images = np.stack([jjudge.load_tensor(p, SIZE)
                       for p in _pngs(tmp_path)])
    got = tjudge.estimate_hands_cpm(images, paths["hpm2d"], paths["hpm3d"],
                                    device="cpu")
    want = jjudge.estimate_hands_cpm(images, paths["hpm2d"], paths["hpm3d"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("judge", ["hand3d", "cpm"])
def test_handpose_judge_cli_writes_the_tfjs_layout(tmp_path, judge):
    sample = tmp_path / "sample"
    sample.mkdir()
    for i, path in enumerate(_pngs(tmp_path)):
        shutil.copy(path, sample / f"{i}.png")
    with pytest.warns(UserWarning, match="RANDOM"):
        lm = tjudge.main([str(sample), "--judge", judge, "--size", str(SIZE),
                          "--device", "cpu", "--checkpoints_dir",
                          str(tmp_path / "none")])
    for i, fname in enumerate(("gt_js.json", "pred_js.json")):
        out = json.loads((sample / fname).read_text())
        assert len(out) == 1 and out[0]["handInViewConfidence"] == 1.0
        marks = np.asarray(out[0]["landmarks"])
        assert marks.shape == (21, 3) and np.isfinite(marks).all()
        np.testing.assert_allclose(marks, lm[i], atol=5e-5)


# -------------------------------------------------------- the ratio driver

def test_driver_hand3d_stages(monkeypatch, tmp_path):
    """Below ratio 1.0, after test_hpe: create_hand3d_db over the aug
    directory, train_hand3d --net posenet for --hand3d_iters and
    eval_hand3d --mode 2d, at the GAN's --fineSize, on --device."""
    calls = []
    monkeypatch.setattr(mm_train_ratio, "run",
                        lambda stage, args: calls.append((stage, args)))
    root = str(tmp_path / "rhd")
    mm_train_ratio.main(["--dataset", "RHD", "--dataroot", root,
                         "--test_dataroot", root, "--ratios", "0.5", "1.0",
                         "--device", "cpu", "--with_hand3d",
                         "--hand3d_iters", "7", "--checkpoints_dir",
                         str(tmp_path / "ck"), "--extra_gan_args",
                         "--fineSize", "64", "--ngf", "8"])
    stages = [s for s, _ in calls]
    assert stages == ["train", "aug", "train_hpe", "test_hpe",
                      "create_hand3d_db", "train_hand3d", "eval_hand3d",
                      "train", "train_hpe", "test_hpe"]
    args = dict(calls[4:7])
    db = str(tmp_path / "ck" / "gan_db_rhd_r0p5.bin")
    assert args["create_hand3d_db"] == [
        "--dataroot", root, "--images", augmentation_dir_for(root, "MM-Hand"),
        "--out", db]
    for stage in ("train_hand3d", "eval_hand3d"):
        a = args[stage]
        assert a[a.index("--bin") + 1] == db
        assert a[a.index("--image_size") + 1] == "64"
        assert a[a.index("--crop_size") + 1] == "64"
        assert a[a.index("--device") + 1] == "cpu"
        assert a[a.index("--name") + 1] == "h3d_rhd_r0p5"
    assert args["train_hand3d"][:4] == ["--net", "posenet", "--max_iter",
                                        "7"]
    assert args["eval_hand3d"][:2] == ["--mode", "2d"]
    calls.clear()
    mm_train_ratio.main(["--dataset", "RHD", "--dataroot", root,
                         "--test_dataroot", root, "--ratios", "0.5",
                         "--with_hand3d"])
    h3d = [a for s, a in calls if s == "train_hand3d"][0]
    assert h3d[h3d.index("--image_size") + 1] == "256"
    assert h3d[h3d.index("--max_iter") + 1] == "30000"
