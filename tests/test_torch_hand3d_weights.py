"""The port's hand3d TF-pickle converter against mmhand_tpu's, on the CPU.

A TF-named pickle is built from mmhand_tpu's random ColorHandPose3D
parameters at crop 32 (the inverse of ``tf_name_to_path``, as
tests/test_hand3d.py builds one), split in two as the reference ships it
(HandSegNet; PoseNet2D, PosePrior and ViewpointNet).  It goes through
``tools/convert_hand3d_weights.tf_dict_to_params`` for mmhand_tpu and
through ``python -m mmhand_torch.scripts.convert_hand3d_weights`` for the
port: both pipelines give the same six outputs on one image within 1e-4,
and the port's ``eval_hand3d --mode full`` reads the written
``state_latest.pt`` and scores as mmhand_tpu's script does on the same
weights.
"""

import functools
import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch.hand3d.system import load_color_hand_pose
from mmhand_torch.scripts import convert_hand3d_weights as tconv
from mmhand_torch.scripts import eval_hand3d as teval
from mmhand_tpu.models import hand3d as jnet
from tools.convert_hand3d_weights import tf_dict_to_params
from test_torch_threads import two_threads  # noqa: F401

SIZE = 32


@functools.lru_cache(maxsize=None)
def _jax_params():
    """mmhand_tpu's ColorHandPose3D at crop 32 from PRNGKey(0), as its
    eval_hand3d draws it without a checkpoint."""
    net = jnet.ColorHandPose3D(crop_size=SIZE)
    return jax.jit(net.init)({"params": jax.random.PRNGKey(0)},
                             jnp.zeros((1, SIZE, SIZE, 3)),
                             jnp.zeros((1, 2)))["params"]


def _tf_dicts(params):
    """The reference's two pickles' dicts: ``<scope>/<layer>/weights`` and
    ``biases``, TF layouts (mmhand_tpu keeps them)."""
    handseg, pose = {}, {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = [p.key for p in path if p.key != "conv"]
        kind = "weights" if names[-1] == "kernel" else "biases"
        name = "/".join(names[:-1] + [kind])
        (handseg if names[0] == "HandSegNet" else pose)[name] = np.asarray(
            leaf, np.float32)
    return handseg, pose


def _write(tmp_path, *dicts):
    paths = []
    for i, d in enumerate(dicts):
        path = tmp_path / f"weights{i}.pickle"
        with open(path, "wb") as f:
            pickle.dump(d, f, protocol=2)
        paths.append(str(path))
    return paths


def test_tf_names_map_to_port_keys():
    assert tconv.tf_name_to_key("HandSegNet/conv1_1/weights") == \
        "HandSegNet.conv1_1.conv.weight"
    assert tconv.tf_name_to_key("PosePrior/fc_rel0/biases") == \
        "PosePrior.fc_rel0.bias"
    with pytest.raises(KeyError):
        tconv.tf_name_to_key("global_step")
    with pytest.raises(KeyError):
        tconv.tf_name_to_key("PoseNet2D/conv1_1/Adam")


def test_pickles_give_jax_outputs(tmp_path):
    """The same pickles through both converters: the six outputs of the
    pipeline on one image within 1e-4."""
    params = _jax_params()
    handseg, pose = _tf_dicts(params)
    template = jax.tree.map(np.zeros_like, params)
    jparams, n = tf_dict_to_params({**handseg, **pose}, template)
    assert n == len(handseg) + len(pose)
    summary = tconv.main([*_write(tmp_path, handseg, pose),
                          "--checkpoints_dir", str(tmp_path / "ck"),
                          "--name", "w"])
    assert summary["filled"] == summary["total"] == n
    assert summary["skipped"] == []
    net, found = load_color_hand_pose(str(tmp_path / "ck"), "w", SIZE, "cpu")
    assert found

    rng = np.random.RandomState(0)
    image = rng.uniform(-0.5, 0.5, (1, SIZE, SIZE, 3)).astype(np.float32)
    image[0, 8:24, 10:22] += 0.4  # something for HandSegNet to find
    side = np.array([[1.0, 0.0]], np.float32)
    want = jax.jit(jnet.ColorHandPose3D(crop_size=SIZE).apply)(
        {"params": jparams}, image, side)
    with torch.no_grad():
        got = net(torch.from_numpy(image), torch.from_numpy(side))
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, i
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4,
                                   err_msg=f"output {i}")


def test_eval_hand3d_full_reads_the_converted_state(tmp_path, monkeypatch):
    """eval_hand3d --mode full --device cpu on the converted weights scores
    as mmhand_tpu's eval_hand3d on the same weights (its own PRNGKey(0)
    draw), EPE rtol 1e-4 and AUC within 1e-6."""
    monkeypatch.setenv("MMHAND_STRICT_PRNG", "1")
    jeval = importlib.import_module("scripts.eval_hand3d")
    monkeypatch.setattr(jeval, "ColorHandPose3D",
                        functools.partial(jnet.ColorHandPose3D,
                                          crop_size=SIZE))
    ck = tmp_path / "ck"
    tconv.main([*_write(tmp_path, *_tf_dicts(_jax_params())),
                "--checkpoints_dir", str(ck), "--name", "e"])
    common = ["--mode", "full", "--image_size", str(SIZE), "--crop_size",
              str(SIZE), "--batch_size", "4", "--name", "e"]
    got = teval.main(common + ["--device", "cpu", "--checkpoints_dir",
                               str(ck)])
    want = jeval.main(common + ["--checkpoints_dir", str(tmp_path / "none")])
    np.testing.assert_allclose([got["mean"], got["median"]],
                               [want["mean"], want["median"]], rtol=1e-4)
    assert got["auc"] == pytest.approx(want["auc"], abs=1e-6)


def test_a_mismatched_shape_or_a_missing_part_raises(tmp_path):
    """A shape that does not fit and a parameter no pickle sets raise;
    names of no layer's weights or biases are skipped."""
    handseg, pose = _tf_dicts(_jax_params())
    bad = dict(pose)
    bad["PosePrior/fc_rel0/weights"] = np.zeros((7, 3), np.float32)
    with pytest.raises(ValueError, match="fc_rel0.*fits no crop size"):
        tconv.main([*_write(tmp_path, handseg, bad), "--checkpoints_dir",
                    str(tmp_path / "ck")])
    # ViewpointNet's Linear of another crop size than PosePrior's
    bad = dict(pose)
    bad["ViewpointNet/fc_vp0/weights"] = np.zeros((256 * 4 + 2, 256),
                                                  np.float32)
    with pytest.raises(ValueError, match="fc_vp0.*does not fit"):
        tconv.main([*_write(tmp_path, handseg, bad), "--checkpoints_dir",
                    str(tmp_path / "ck")])
    with pytest.raises(ValueError, match="unset"):
        tconv.main([*_write(tmp_path, handseg), "--checkpoints_dir",
                    str(tmp_path / "ck")])
    extra = {**handseg, "global_step": np.zeros(()),
             "HandSegNet/conv1_1/weights/Adam": np.zeros(1)}
    summary = tconv.main([*_write(tmp_path, extra, pose), "--checkpoints_dir",
                          str(tmp_path / "ck")])
    assert sorted(summary["skipped"]) == sorted(
        ["global_step", "HandSegNet/conv1_1/weights/Adam"])
