"""The port's posenet training against the benchmark's plain reference
(``benchmark.reference.hand3d``, written from ColorHandPose3D's published
description, not from the port): at 64 px, batch 2, three steps of
``Hand3DSystem("posenet")`` through ``derive_batch`` and
``make_hand3d_train_step``, from the same weights, the same records of a
packed GAN DB and the same noise; and the derivation alone on records
whose hand side comes from the mask, from the visible keypoints, and from
a tie."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import hand3d as ref
from benchmark.reference.gan import load_weights
from mmhand_torch.data.hand3d_binary import Hand3dBinaryDataset, write_record
from mmhand_torch.hand3d import (
    Hand3DSystem,
    derive_batch,
    make_hand3d_train_step,
)
from mmhand_torch.scripts.train_hand3d import (
    pipeline_config_for,
    records_to_pipeline_batch,
)
from test_torch_threads import two_threads  # noqa: F401

SIZE = 64
BATCHES = [[0, 1], [2, 3], [4, 5]]
# (mask, visible keypoints): which hand each record's derivation takes
RECORDS = {
    0: "no hand pixel, the left hand's 21 keypoints visible: left",
    1: "right-hand pixels only: right",
    2: "more left-hand pixels than right-hand ones: left",
    3: "no hand pixel, more right keypoints visible: right",
    4: "no hand pixel, as many visible on each side: left (the tie)",
    5: "left-hand pixels, keypoints off the frame and invisible: left",
    6: "as many left-hand pixels as right-hand ones: right",
}
LEFT = {0: True, 1: False, 2: True, 3: False, 4: True, 5: True, 6: False}


def _record(i: int, rng: np.random.RandomState) -> dict:
    s = SIZE
    uv = rng.uniform(8, s - 8, (42, 2)).astype(np.float32)
    xyz = rng.uniform(-0.1, 0.6, (42, 3)).astype(np.float32)
    vis = np.ones(42, np.uint8)
    mask = np.ones((s, s), np.uint8)
    if i == 0:      # the GAN DB's own form: right hand zero padding
        uv[21:], xyz[21:], vis[21:] = 0.0, 0.0, 0
    elif i == 1:
        mask[10:30, 10:30] = 19
    elif i == 2:
        mask[5:35, 5:35] = 4
        mask[40:50, 40:50] = 20
    elif i == 3:
        vis[:21] = rng.uniform(size=21) < 0.5
    elif i == 4:
        vis[3:9] = 0
        vis[24:30] = 0
    elif i == 5:
        mask[20:40, 20:40] = 7
        # off the frame by more than the uv noise's 5 px
        uv[3] = (-20.0, 10.0)
        uv[5] = (10.0, s + 20.0)
        vis[9] = vis[14] = 0
    elif i == 6:
        mask[0:10, 0:10] = 2
        mask[50:60, 50:60] = 18
    return {"image": rng.randint(0, 256, (s, s, 3)).astype(np.uint8),
            "mask": mask, "xyz": xyz, "uv": uv, "vis": vis,
            "K": np.eye(3, dtype=np.float32) * s}


@pytest.fixture(scope="module")
def db(tmp_path_factory) -> str:
    path = tmp_path_factory.mktemp("hand3d_ref") / "db.bin"
    rng = np.random.RandomState(2024)
    with open(path, "wb") as fh:
        for i in sorted(RECORDS):
            r = _record(i, rng)
            write_record(fh, r["image"], r["mask"], r["xyz"], r["uv"],
                         r["vis"], r["K"])
    return str(path)


def _program_batch(db: str, idx, gen: torch.Generator):
    """derive_batch on the records ``idx``, and the uniforms its noise
    draw took."""
    ds = Hand3dBinaryDataset(db, SIZE, SIZE)
    raw = records_to_pipeline_batch([ds[i] for i in idx])
    drew = gen.get_state()
    cfg = pipeline_config_for("posenet", (SIZE, SIZE), SIZE)
    batch = derive_batch(raw, cfg, gen, "cpu")
    replay = torch.Generator()
    replay.set_state(drew)
    return batch, torch.rand((len(idx), 42, 2), generator=replay)


@pytest.fixture(scope="module")
def runs(db):
    """Three steps of the program and of the reference from one start:
    each step's loss, the first step's gradients, the end's parameters."""
    system = Hand3DSystem("posenet", crop_size=SIZE, device="cpu", seed=5)
    start = {k.replace(".conv.", "."): p.detach().clone()
             for k, p in system.module.named_parameters()}
    net = ref.PoseNet2D()
    load_weights({"posenet": net},
                 {f"posenet.{k}": v for k, v in start.items()})
    step = make_hand3d_train_step(system)
    gen = torch.Generator().manual_seed(6)
    got = {"losses": [], "grads": {}}
    batches = []
    for i, idx in enumerate(BATCHES):
        batch, uniforms = _program_batch(db, idx, gen)
        got["losses"].append(float(step(batch)))
        if i == 0:
            got["grads"] = {k.replace(".conv.", "."): p.grad.clone()
                            for k, p in system.module.named_parameters()}
        batches.append(ref.posenet_batch(ref.read_records(db, idx, SIZE),
                                         uniforms, SIZE, "cpu"))
    got["params"] = {k.replace(".conv.", "."): p.detach().clone()
                     for k, p in system.module.named_parameters()}

    want = {"losses": [], "grads": {}}
    params = dict(net.named_parameters())
    state = {}
    for i, b in enumerate(batches):
        loss = ref.posenet_loss(net(b["image"]), b["scoremap"], b["vis"])
        grads = torch.autograd.grad(loss, list(params.values()))
        if i == 0:
            want["grads"] = dict(zip(params, grads))
        ref.adam_step(list(params.values()), grads, state,
                      ref.staged_lr(i), ref.BETAS, ref.EPS)
        want["losses"].append(float(loss.detach()))
    want["params"] = {k: p.detach().clone() for k, p in params.items()}
    return got, want, start


@pytest.mark.parametrize("step", range(len(BATCHES)))
def test_step_loss_matches_reference(runs, step):
    got, want, _ = runs
    assert want["losses"][step] > 0.0
    # float32 on both sides; the two sum the RMSE's mean and the convs'
    # products in their own orders, a few ulps of the loss
    assert got["losses"][step] == pytest.approx(want["losses"][step],
                                                rel=1e-5)


def test_every_first_gradient_matches_reference(runs):
    got, want, _ = runs
    assert set(got["grads"]) == set(want["grads"])
    for leaf, w in want["grads"].items():
        g = got["grads"][leaf]
        assert float(w.norm()) > 0.0, leaf
        # a gradient is a sum over the batch and the frame that partly
        # cancels; float32 in two summation orders leaves ~4e-6 of its norm
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()), leaf


def test_parameter_changes_match_reference(runs):
    got, want, start = runs
    for leaf, w in want["params"].items():
        dw = w - start[leaf]
        dg = got["params"][leaf] - start[leaf]
        assert float(dw.norm()) > 0.0, leaf
        # Adam's first step is lr * sign(g): an element whose gradient
        # rounds across 0 moves 2 lr the other way, so the change is held
        # by the leaf's norm, not element by element
        assert float((dg - dw).norm()) <= 1e-3 * float(dw.norm()), leaf


@pytest.fixture(scope="module")
def derived(db):
    gen = torch.Generator().manual_seed(7)
    idx = sorted(RECORDS)
    batch, uniforms = _program_batch(db, idx, gen)
    want = ref.posenet_batch(ref.read_records(db, idx, SIZE), uniforms,
                             SIZE, "cpu")
    return batch, want


@pytest.mark.parametrize("i", sorted(RECORDS))
def test_hand_side_and_visibility_match_reference(derived, i):
    batch, want = derived
    assert bool(want["left"][i]) == LEFT[i], RECORDS[i]
    assert bool(batch["hand_side"][i, 0] == 1) == LEFT[i], RECORDS[i]
    assert bool(batch["hand_side"][i, 1] == 1) == (not LEFT[i])
    assert torch.equal(batch["keypoint_vis21"][i].bool(), want["vis"][i])


@pytest.mark.parametrize("i", sorted(RECORDS))
def test_scoremaps_match_reference(derived, i):
    batch, want = derived
    got, exp = batch["scoremap"][i], want["scoremap"][i]
    assert got.shape == exp.shape == (SIZE, SIZE, ref.NUM_KP)
    # both truncate the same float32 coordinates and take exp of the same
    # integer distance over sigma^2: equal but for the last ulp of exp
    torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-7)
    # a keypoint the reference leaves out (invisible or off the frame)
    # has an empty map, one it keeps a peak of 1
    kept = exp.amax(dim=(0, 1)) > 0
    assert torch.equal(got.amax(dim=(0, 1)) > 0, kept)
    assert torch.all(exp.amax(dim=(0, 1))[kept] == 1.0)


def test_images_match_reference(derived):
    batch, want = derived
    # x / 255 - 0.5 on the same uint8 values, in the same order
    assert torch.equal(batch["image"], want["image"])


def test_off_frame_keypoints_have_no_map(derived):
    _, want = derived
    vis = want["vis"][5]
    maps = want["scoremap"][5].amax(dim=(0, 1))
    # record 5: keypoints 3 and 5 off the frame, 9 and 14 invisible; the
    # others lie 8 px or more inside it, beyond the noise's 5 px
    for k in (3, 5, 9, 14):
        assert maps[k] == 0.0, k
    assert not vis[9] and not vis[14]
    assert int((maps > 0).sum()) == 17
