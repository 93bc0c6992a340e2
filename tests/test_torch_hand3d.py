"""mmhand_torch's hand3d stack against mmhand_tpu's on the CPU: the
coordinate trafos, the image ops, the five nets through
``convert.hand3d_state_dict_from_jax``, the sample pipeline (with its
repaired hand side) and three train steps of every subnet.

Inputs are numpy arrays drawn from a seed, at 32-64 px; the nets keep their
full widths.  Both sides start from mmhand_tpu's initial parameters.
Tolerances:
* image ops and trafos: atol 1e-5;
* single_obj_scoremap, calc_center_bb, find_max_location,
  detect_keypoints and the hand side: exact;
* the pipeline's fields: atol 1e-5 and rtol 1e-5 (the normalised
  coordinates scale with 1 / |kp12 - kp11|), the masks, visibility and
  hand side exact;
* net forwards: rtol 1e-4, atol 1e-5;
* train steps, as tests/test_torch_hpe.py: losses rtol 2e-4; parameters
  rtol 1e-3, atol 2e-5 on all but 0.5% of each net's elements, every
  element within 2 lr per update (Adam's first update is lr * sign(g)).
Lifting's dropout cannot draw mmhand_tpu's masks, so its steps run with
dropout off on both sides (flax's Dropout replaced inside the test); the
keep rates are checked on their own.
"""

import functools
import re
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmhand_torch.convert import hand3d_state_dict_from_jax
from mmhand_torch.data import hand3d_binary as tbin
from mmhand_torch.hand3d import pipeline as tpipe
from mmhand_torch.hand3d import system as tsys
from mmhand_torch.models import hand3d as tnet
from mmhand_torch.ops import hand3d_image as timg
from mmhand_torch.ops import hand_trafo as ttrafo
from mmhand_torch.scripts.train_hand3d import records_to_pipeline_batch
from mmhand_torch.utils.checkpoint import CheckpointManager
from mmhand_tpu.data import hand3d_binary as jbin
from mmhand_tpu.hand3d import pipeline as jpipe
from mmhand_tpu.hand3d import system as jsys
from mmhand_tpu.models import hand3d as jnet
from mmhand_tpu.ops import hand3d_image as jimg
from mmhand_tpu.ops import hand_trafo as jtrafo
from test_torch_threads import two_threads  # noqa: F401

SIZE, B = 32, 2
REPO = Path(__file__).resolve().parent.parent


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-5, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ------------------------------------------------------------- the trafos

def test_atan2_ref_keeps_the_reference_quirk():
    """Each quadrant, the axes and x within 1e-8 of 0, where the +1e-8 in
    the denominator flips the branch."""
    y = np.array([1, 1, -1, -1, 0, 1, -1, 0.5, 0.5, 1e-9], np.float32)
    x = np.array([1, -1, 1, -1, 1, 0, 0, -1e-8, -2e-8, -1e-8], np.float32)
    got = ttrafo.atan2_ref(_t(y), _t(x)).numpy()
    _close(got, jtrafo.atan2_ref(jnp.asarray(y), jnp.asarray(x)))
    # x = -1e-8 adds to 0: atan(y / 0) = pi/2, no pi branch
    assert got[7] == pytest.approx(np.pi / 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_canonical_trafo_matches_jax(seed):
    xyz = np.random.RandomState(seed).normal(size=(4, 21, 3)).astype(
        np.float32)
    got = ttrafo.canonical_trafo(_t(xyz))
    want = jtrafo.canonical_trafo(jnp.asarray(xyz))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    # the whole rotation reproduces the output from the root-centred input
    rel = xyz - xyz[:, :1]
    _close(rel @ got[1].numpy(), got[0].numpy(), atol=1e-5)


@pytest.mark.parametrize("batched", [True, False])
def test_flip_right_hand_matches_jax(batched):
    xyz = np.random.RandomState(2).normal(size=(3, 21, 3)).astype(np.float32)
    cond = np.array([True, False, True])
    if not batched:
        xyz, cond = xyz[0], np.asarray(True)
    got = ttrafo.flip_right_hand(_t(xyz), _t(cond)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtrafo.flip_right_hand(
        jnp.asarray(xyz), jnp.asarray(cond))))


@pytest.mark.parametrize("seed", [0, 1])
def test_bone_rel_trafo_and_inverse_match_jax(seed):
    """Both directions, and the round trip; the homogeneous x-rotation's
    sign convention is the opposite of the canonical one."""
    xyz = np.random.RandomState(seed).normal(size=(3, 21, 3)).astype(
        np.float32)
    rel = ttrafo.bone_rel_trafo(_t(xyz))
    _close(rel.numpy(), jtrafo.bone_rel_trafo(jnp.asarray(xyz)))
    back = ttrafo.bone_rel_trafo_inv(rel)
    _close(back.numpy(), jtrafo.bone_rel_trafo_inv(jnp.asarray(rel.numpy())))
    _close(back.numpy(), xyz, atol=1e-5)
    angle = torch.tensor([0.3])
    assert ttrafo._hom_rot_x(angle)[0, 1, 2] == -ttrafo._rot_x(angle)[0, 1, 2]
    assert ttrafo.KINEMATIC_ORDER == jtrafo.KINEMATIC_ORDER
    assert ttrafo.KINEMATIC_PARENT == jtrafo.KINEMATIC_PARENT


# -------------------------------------------------------------- image ops

@pytest.mark.parametrize("out_hw", [(9, 11), (64, 64), (3, 2), (5, 7)])
def test_resize_bilinear_tf1_matches_jax(out_hw):
    x = np.random.RandomState(3).normal(size=(2, 5, 7, 3)).astype(np.float32)
    got = timg.resize_bilinear_tf1(_t(x), out_hw)
    _close(got.numpy(), jimg.resize_bilinear_tf1(jnp.asarray(x), out_hw))
    if out_hw == (64, 64):
        # TF1's src = i * in / out, not torch's half-pixel centres
        half = F.interpolate(_t(x).permute(0, 3, 1, 2), out_hw,
                             mode="bilinear", align_corners=False)
        assert (half.permute(0, 2, 3, 1) - got).abs().max() > 1e-2


def test_crop_and_resize_matches_jax():
    """Boxes inside, across and beyond the edges: each neighbour outside
    the image reads 0 on its own."""
    img = np.random.RandomState(4).normal(size=(4, 20, 24, 3)).astype(
        np.float32)
    boxes = np.array([[0, 0, 1, 1], [-0.3, 0.2, 0.8, 1.4],
                      [0.1, -0.5, 0.3, 0.2], [1.1, 1.1, 1.5, 1.3]],
                     np.float32)
    got = timg.crop_and_resize(_t(img), _t(boxes), 13).numpy()
    _close(got, jimg.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes),
                                     13))
    square = img[:1, :20, :20]
    _close(timg.crop_and_resize(_t(square), _t(boxes[:1]), 20).numpy(),
           square)
    assert np.abs(got[1]).max() > 0 and got[3].max() == 0.0


def test_crop_image_from_xy_matches_jax():
    rng = np.random.RandomState(5)
    img = rng.normal(size=(3, 20, 24, 3)).astype(np.float32)
    loc = rng.uniform(0, 20, (3, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 3, 3).astype(np.float32)
    got = timg.crop_image_from_xy(_t(img), _t(loc), 16, _t(scale)).numpy()
    _close(got, jimg.crop_image_from_xy(jnp.asarray(img), jnp.asarray(loc),
                                        16, jnp.asarray(scale)))
    one = timg.crop_image_from_xy(_t(img), _t(loc), 16, 1.0).numpy()
    _close(one, jimg.crop_image_from_xy(jnp.asarray(img), jnp.asarray(loc),
                                        16, 1.0))


def test_argmax_decoders_take_the_first_maximum():
    rng = np.random.RandomState(6)
    s = rng.randint(0, 3, (3, 6, 7)).astype(np.float32)   # many ties
    got = timg.find_max_location(_t(s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jimg.find_max_location(jnp.asarray(s))))
    assert got.dtype == torch.int32
    maps = rng.randint(0, 3, (2, 5, 6, 4)).astype(np.float32)
    got = timg.detect_keypoints(_t(maps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jimg.detect_keypoints(jnp.asarray(maps))))
    flat = maps.reshape(2, 30, 4).argmax(1)
    np.testing.assert_array_equal(got.numpy()[..., 0], flat // 6)


def _blob_logits(seed, size=64):
    """Two-class logits with noise and a few foreground blobs of random
    strength."""
    rng = np.random.RandomState(seed)
    logits = rng.normal(size=(2, size, size, 2)).astype(np.float32)
    for b in range(2):
        for _ in range(3):
            y, x = rng.randint(0, size - 12, 2)
            logits[b, y:y + rng.randint(4, 12), x:x + rng.randint(4, 12),
                   1] += rng.uniform(3, 8)
    return logits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_single_obj_scoremap_matches_jax_exactly(seed):
    logits = _blob_logits(seed)
    got = timg.single_obj_scoremap(_t(logits)).numpy()
    want = np.asarray(jimg.single_obj_scoremap(jnp.asarray(logits)))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 64, 64, 1) and 0 < got.sum() < got.size
    center, bb, crop = timg.calc_center_bb(_t(got))
    for g, w in zip((center, bb, crop), jimg.calc_center_bb(
            jnp.asarray(want))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_single_obj_scoremap_passes_at_256():
    """max(H, W) // 10 rounds: 25 at 256 px, each a 21x1 and a 1x21 pool,
    which equal the 21x21 window."""
    calls = []
    real = F.max_pool2d

    def counting(x, *args, **kw):
        calls.append(args[0])
        return real(x, *args, **kw)

    logits = np.zeros((1, 256, 256, 2), np.float32)
    logits[0, 100:140, 30:200, 1] = 5.0
    F.max_pool2d = counting
    try:
        mask = timg.single_obj_scoremap(_t(logits))
    finally:
        F.max_pool2d = real
    assert calls == [(21, 1), (1, 21)] * 25
    assert float(mask.sum()) == 40 * 170
    x = torch.rand(2, 1, 40, 50)
    sep = real(real(x, (21, 1), 1, (10, 0)), (1, 21), 1, (0, 10))
    assert torch.equal(sep, real(x, 21, 1, 10))


def test_calc_center_bb_matches_jax_with_an_empty_mask():
    m = np.zeros((3, 20, 30), np.float32)
    m[0, 4:10, 6:16] = 1.0
    m[2, 19, 0] = 1.0
    got = timg.calc_center_bb(_t(m))
    for g, w in zip(got, jimg.calc_center_bb(jnp.asarray(m))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].numpy()[1], [160.0, 160.0])
    assert float(got[2][1, 0]) == 100.0


@pytest.mark.parametrize("batched", [False, True])
def test_gaussian_scoremap_matches_jax(batched):
    rng = np.random.RandomState(7)
    coords = rng.uniform(-2, 20, (3, 21, 2)).astype(np.float32)
    valid = rng.rand(3, 21) > 0.3
    if batched:
        got = timg.gaussian_scoremap(_t(coords), (16, 18), 3.0, _t(valid))
        want = np.stack([np.asarray(jimg.gaussian_scoremap(
            jnp.asarray(c), (16, 18), 3.0, jnp.asarray(v)))
            for c, v in zip(coords, valid)])
    else:
        got = timg.gaussian_scoremap(_t(coords[0]), (16, 18), 3.0)
        want = jimg.gaussian_scoremap(jnp.asarray(coords[0]), (16, 18), 3.0)
    _close(got.numpy(), want)


# ------------------------------------------------------------------ nets

@functools.lru_cache(maxsize=None)
def _jax_system(net, variant):
    system = jsys.Hand3DSystem(net=net, variant=variant, crop_size=SIZE)
    state = jax.jit(system.init_state, static_argnums=1)(
        jax.random.PRNGKey(0), (SIZE, SIZE))
    return system, state


def _init(module, *shapes):
    args = [jnp.zeros(s) for s in shapes]
    return jax.jit(module.init)({"params": jax.random.PRNGKey(0),
                                 "dropout": jax.random.PRNGKey(1)},
                                *args)["params"]


def _load(net, params):
    """The port's ``net`` with mmhand_tpu's ``params``; the converted keys
    are exactly the port's."""
    sd = hand3d_state_dict_from_jax(params)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    return net


def _net_inputs(kind):
    rng = np.random.RandomState(8)
    side = np.array([[1, 0], [0, 1]], np.float32)
    if kind in ("segnet", "posenet"):
        return (rng.uniform(-0.5, 0.5, (2, SIZE, SIZE, 3)).astype(
            np.float32),)
    s = SIZE // 8 if kind in ("prior", "bottleneck", "viewpoint") else SIZE
    return rng.uniform(0, 1, (2, s, s, 21)).astype(np.float32), side


NETS = {
    "segnet": (jnet.HandSegNet, tnet.HandSegNet),
    "posenet": (jnet.PoseNet2D, tnet.PoseNet2D),
    "prior": (jnet.PosePrior, functools.partial(tnet.PosePrior, in_size=4)),
    "bottleneck": (functools.partial(jnet.PosePrior, bottleneck=True),
                   functools.partial(tnet.PosePrior, bottleneck=True,
                                     in_size=4)),
    "viewpoint": (jnet.ViewpointNet,
                  functools.partial(tnet.ViewpointNet, in_size=4)),
}


def _net_params(kind, jmod, inputs):
    """The trainer's initial parameters where mmhand_tpu trains the net,
    else the net's own init."""
    if kind in ("segnet", "posenet"):
        net = {"segnet": "handsegnet", "posenet": "posenet"}[kind]
        return _jax_system(net, "proposed")[1].params
    return _init(jmod, *[x.shape for x in inputs])


@pytest.mark.parametrize("kind", list(NETS))
def test_net_forward_matches_jax(kind):
    jcls, tcls = NETS[kind]
    inputs = _net_inputs(kind)
    jmod = jcls()
    params = _net_params(kind, jmod, inputs)
    port = _load(tcls(), params)
    with torch.no_grad():
        got = port(*map(_t, inputs))
    want = jax.jit(jmod.apply)({"params": params}, *map(jnp.asarray, inputs))
    if kind == "posenet":
        assert len(got) == len(want) == 3
        assert got[0].shape == (2, SIZE // 8, SIZE // 8, 21)
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        _close(g.numpy(), w, atol=1e-5, rtol=1e-4, what=kind)


@pytest.mark.parametrize("variant", tnet.LIFTING_VARIANTS)
def test_lifting_variant_forward_matches_jax(variant):
    sm, side = _net_inputs("lifting")
    jmod = jnet.PosePriorNetwork(variant=variant)
    params = _jax_system("lifting", variant)[1].params
    port = _load(tnet.PosePriorNetwork(variant, crop_size=SIZE), params)
    with torch.no_grad():
        got = port(_t(sm), _t(side))
    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(sm),
                               jnp.asarray(side))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g.numpy(), w, atol=1e-5, rtol=1e-4, what=variant)
    assert ("fc_bottleneck" in params["PosePrior"]) == (
        variant == "bottleneck")


def _full_params():
    """ColorHandPose3D's tree from the trainers' initial subnets: at crop
    32 PosePrior and ViewpointNet read 4x4 maps in both."""
    lifting = _jax_system("lifting", "proposed")[1].params
    return {"HandSegNet": _jax_system("handsegnet", "proposed")[1].params,
            "PoseNet2D": _jax_system("posenet", "proposed")[1].params,
            "PosePrior": lifting["PosePrior"],
            "ViewpointNet": lifting["ViewpointNet"]}


def _full_port():
    return _load(tnet.ColorHandPose3D(crop_size=SIZE), _full_params())


@pytest.mark.parametrize("crop_externally", [False, True])
def test_color_hand_pose3d_matches_jax(crop_externally):
    """The 6-tuple: the mask-derived centre and scale exactly, the rest at
    the nets' tolerance; and the four parts alone."""
    image, side = _net_inputs("segnet")[0], np.array([[1, 0], [0, 1]],
                                                     np.float32)
    jmod = jnet.ColorHandPose3D(crop_size=SIZE)
    port = _full_port()
    with torch.no_grad():
        got = port(_t(image), _t(side), crop_externally=crop_externally)
    want = jax.jit(functools.partial(jmod.apply,
                                     crop_externally=crop_externally))(
        {"params": _full_params()}, jnp.asarray(image), jnp.asarray(side))
    names = ("hand_scoremap", "image_crop", "scale_crop", "center",
             "keypoints_scoremap", "keypoint_coord3d")
    shapes = ((2, SIZE, SIZE, 2), (2, SIZE, SIZE, 3), (2, 1), (2, 2),
              (2, SIZE, SIZE, 21), (2, 21, 3))
    for name, shape, g, w in zip(names, shapes, got, want):
        assert g.shape == shape, name
        if name in ("scale_crop", "center"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        else:
            _close(g.numpy(), w, atol=1e-5, rtol=1e-4, what=name)
    if crop_externally:
        return
    # the parts alone give the pipeline's pieces
    with torch.no_grad():
        assert torch.equal(port.detection(_t(image)), got[0])
        maps = port.pose2d(got[1])
        assert torch.equal(timg.resize_bilinear_tf1(maps[-1], (SIZE, SIZE)),
                           got[4])
        assert torch.equal(port.pose3d(maps[-1], _t(side)), got[5])


def test_tf_conv_pads_as_tf_same():
    """At stride 2 on an even side TF pads 0 before and 1 after; the port
    matches flax's "SAME", where nn.Conv2d(padding=1) does not."""
    assert tnet.same_pads(8, 3, 2) == (0, 1)
    assert tnet.same_pads(7, 3, 2) == (1, 1)
    assert tnet.same_pads(8, 7, 1) == (3, 3)
    x = np.random.RandomState(9).normal(size=(1, 8, 8, 4)).astype(np.float32)
    jconv = fnn.Conv(5, (3, 3), strides=(2, 2), padding="SAME")
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = tnet.TFConv(4, 5, 3, 2)
    port.conv.load_state_dict(hand3d_state_dict_from_jax(params))
    with torch.no_grad():
        got = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        sym = F.conv2d(_t(x).permute(0, 3, 1, 2), port.conv.weight,
                       port.conv.bias, stride=2, padding=1)
    want = jconv.apply({"params": params}, jnp.asarray(x))
    _close(got.numpy(), want)
    assert (sym.permute(0, 2, 3, 1) - got).abs().max() > 1e-2


def test_init_is_xavier_uniform_with_bias_1e4():
    """The reference's init from a seed: each weight within
    sqrt(6 / (fan_in + fan_out)) with the uniform's spread, each bias 1e-4,
    and the same draw again."""
    net = tnet.init_hand3d(tnet.ViewpointNet(in_size=4),
                           torch.Generator().manual_seed(3))
    for name, m in net.named_modules():
        if not isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            continue
        w = m.weight
        rf = w[0, 0].numel() if w.dim() == 4 else 1
        bound = np.sqrt(6.0 / ((w.shape[0] + w.shape[1]) * rf))
        assert float(w.detach().abs().max()) <= bound
        if w.numel() > 1000:
            assert abs(float(w.std()) / (bound / np.sqrt(3)) - 1) < 0.05, name
        assert torch.all(m.bias == 1e-4)
    again = tnet.init_hand3d(tnet.ViewpointNet(in_size=4),
                             torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(
        net.state_dict().values(), again.state_dict().values()))


@pytest.mark.parametrize("net,keep", [("prior", 0.8), ("viewpoint", 0.75)])
def test_dropout_keep_rates(net, keep):
    """In training each Dense output is kept with the reference's
    probability and scaled by 1 / keep; in evaluation nothing drops."""
    cls = tnet.PosePrior if net == "prior" else tnet.ViewpointNet
    assert cls.KEEP == keep
    x = torch.ones(400, 512)
    gen = torch.Generator().manual_seed(0)
    out = tnet.dropout(x, keep, True, gen)
    kept = out != 0
    assert abs(float(kept.float().mean()) - keep) < 0.01
    assert torch.allclose(out[kept], torch.tensor(1 / keep))
    assert torch.equal(tnet.dropout(x, keep, False, None), x)
    with pytest.raises(ValueError, match="Generator"):
        tnet.dropout(x, keep, True, None)
    sm, side = _net_inputs("viewpoint")
    port = tnet.init_hand3d(cls(in_size=4), gen)
    with torch.no_grad():
        a = port(_t(sm), _t(side), train=True, generator=gen)
        b = port(_t(sm), _t(side), train=True, generator=gen)
        c = port(_t(sm), _t(side))
    assert not torch.equal(a, b) and torch.equal(c, port(_t(sm), _t(side)))


def test_rot_mat_from_axis_angle_matches_jax():
    u = np.random.RandomState(10).normal(size=(5, 3)).astype(np.float32)
    u[4] = 0.0
    cols = [u[:, i:i + 1] for i in range(3)]
    got = tnet.rot_mat_from_axis_angle(*map(_t, cols)).numpy()
    _close(got, jnet.rot_mat_from_axis_angle(*map(jnp.asarray, cols)))
    _close(got @ got.transpose(0, 2, 1), np.tile(np.eye(3), (5, 1, 1)),
           atol=1e-5)


# -------------------------------------------------------------- pipeline

def _records(n=4, seed=11, size=SIZE, sides=("l", "r", "l", "r")):
    """Raw records with left- (labels 2-17) or right-hand (>17) pixels,
    ~80% visible keypoints, some uv off the frame."""
    rng = np.random.RandomState(seed)
    masks = np.zeros((n, size, size), np.uint8)
    for i, s in zip(range(n), sides):
        y, x = rng.randint(0, size // 2, 2)
        masks[i, y:y + size // 3, x:x + size // 3] = (
            rng.randint(2, 18) if s == "l" else rng.randint(18, 34))
    return {"keypoint_xyz": rng.normal(size=(n, 42, 3)).astype(np.float32),
            "keypoint_uv": rng.uniform(-3, size + 3, (n, 42, 2)).astype(
                np.float32),
            "cam_mat": rng.normal(size=(n, 3, 3)).astype(np.float32),
            "image": rng.randint(0, 256, (n, size, size, 3)).astype(
                np.uint8),
            "hand_parts": masks,
            "keypoint_vis": rng.rand(n, 42) > 0.2}


CONFIGS = {
    "handsegnet": dict(use_wrist_coord=False),
    "wrist": dict(use_wrist_coord=True),
    "lifting": dict(crop_size=SIZE, use_wrist_coord=False, hand_crop=True),
    "eval_crop16": dict(crop_size=16, use_wrist_coord=False, hand_crop=True),
}
EXACT = ("hand_side", "keypoint_vis21", "hand_mask")


@functools.lru_cache(maxsize=None)
def _jax_deriver(cfg):
    """mmhand_tpu's derive_batch for ``cfg``, jitted once."""
    return jax.jit(lambda r: jpipe.derive_batch(r, cfg,
                                                jax.random.PRNGKey(0)))


def _jax_derive(raw, cfg):
    return _jax_deriver(cfg)(raw)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_derive_batch_matches_jax(name):
    """Every field with the noise off, on records whose masks hold hand
    pixels (the side rule is mmhand_tpu's there)."""
    raw = _records()
    kw = dict(image_size=(SIZE, SIZE), **CONFIGS[name])
    got = tpipe.derive_batch(raw, tpipe.PipelineConfig(**kw),
                             torch.Generator(), "cpu")
    want = _jax_derive(raw, jpipe.PipelineConfig(**kw))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        if k in EXACT:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        else:
            _close(got[k].numpy(), want[k], atol=1e-5, rtol=1e-5, what=k)
    np.testing.assert_array_equal(got["hand_side"].numpy()[:, 0],
                                  [1, 0, 1, 0])


def test_derive_batch_noise_draws():
    """The truncated normal stays within 2 sigma with the right spread, the
    crop scale noise within [1, 1.2], the channel dropout keeps ~0.8, and
    one generator state draws the same batch again."""
    gen = torch.Generator().manual_seed(0)
    z = tpipe.trunc_normal((20000,), 2.5, gen, "cpu")
    assert float(z.abs().max()) <= 5.0
    # the standard deviation of N(0, 1) truncated at 2
    assert abs(float(z.std()) / 2.5 - 0.8796) < 0.02
    u = tpipe._uniform((5000,), 1.0, 1.2, gen, "cpu")
    assert 1.0 <= float(u.min()) and float(u.max()) <= 1.2
    raw = _records(n=4)
    cfg = tpipe.PipelineConfig(
        image_size=(SIZE, SIZE), crop_size=SIZE, use_wrist_coord=False,
        hand_crop=True, coord_uv_noise=True, crop_center_noise=True,
        crop_scale_noise=True, crop_offset_noise=True,
        scoremap_dropout=True)
    quiet = tpipe.derive_batch(raw, tpipe.PipelineConfig(
        image_size=(SIZE, SIZE), crop_size=SIZE, use_wrist_coord=False,
        hand_crop=True), gen, "cpu")
    state = gen.get_state()
    a = tpipe.derive_batch(raw, cfg, gen, "cpu")
    gen.set_state(state)
    b = tpipe.derive_batch(raw, cfg, gen, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["keypoint_uv21"], quiet["keypoint_uv21"])
    assert float(a["crop_scale"].min()) >= 1.0
    drop = tpipe.PipelineConfig(
        image_size=(SIZE, SIZE), crop_size=SIZE, use_wrist_coord=False,
        hand_crop=True, scoremap_dropout=True)
    on = quiet["scoremap"].amax(dim=(1, 2)) > 0
    kept = [tpipe.derive_batch(raw, drop, gen, "cpu")["scoremap"].amax(
        dim=(1, 2))[on] > 0 for _ in range(20)]
    assert 0.75 < float(torch.cat(kept).float().mean()) < 0.85


def test_gan_db_records_train_posenet_in_the_port_not_in_jax(tmp_path):
    """The repair.  write_gan_db writes a mask of ones and the 21 real
    keypoints in rows 0-20 (zero padding in 21-41).  mmhand_tpu's rule sees
    no hand pixel, takes the right hand's rows and derives no visible
    keypoint, so its posenet loss is 0; the port takes the left rows: 21
    visible keypoints and a positive loss."""
    rng = np.random.RandomState(12)
    samples = [{"image": rng.randint(0, 256, (SIZE, SIZE, 3)).astype(
                    np.uint8),
                "uv": rng.uniform(4, SIZE - 4, (21, 2)).astype(np.float32),
                "xyz": rng.uniform(-0.1, 0.1, (21, 3)).astype(np.float32),
                "K": np.eye(3, dtype=np.float32)} for _ in range(2)]
    path = str(tmp_path / "gan.bin")
    jbin.write_gan_db(path, samples)
    db = tbin.Hand3dBinaryDataset(path, SIZE, SIZE)
    raw = records_to_pipeline_batch([db[0], db[1]])
    assert (raw["hand_parts"] == 1).all()
    kw = dict(image_size=(SIZE, SIZE), use_wrist_coord=False)
    want = _jax_derive(raw, jpipe.PipelineConfig(**kw))
    assert int(np.asarray(want["keypoint_vis21"]).sum()) == 0
    assert float(np.asarray(want["scoremap"]).max()) == 0.0
    np.testing.assert_array_equal(np.asarray(want["hand_side"]),
                                  [[0, 1], [0, 1]])
    got = tpipe.derive_batch(raw, tpipe.PipelineConfig(**kw),
                             torch.Generator(), "cpu")
    np.testing.assert_array_equal(got["keypoint_vis21"].numpy().sum(1),
                                  [21, 21])
    np.testing.assert_array_equal(got["hand_side"].numpy(), [[1, 0], [1, 0]])
    assert float(got["scoremap"].max()) > 0.5
    assert np.isfinite(got["keypoint_xyz21_normed"].numpy()).all()

    system = tsys.Hand3DSystem("posenet", device="cpu")
    params = _jax_system("posenet", "proposed")[1].params
    system.module.load_state_dict(hand3d_state_dict_from_jax(params))
    with torch.no_grad():
        assert float(system.loss_fn(got)) > 0.1
    jloss = jax.jit(_jax_system("posenet", "proposed")[0].loss_fn)(
        params, want, None)
    assert float(jloss) == 0.0


def test_side_rule_where_the_mask_has_hand_pixels():
    """More left than right pixels: left; more right: right; equal nonzero
    counts: right, as mmhand_tpu; none: the side with more visible
    keypoints (the left on a tie)."""
    raw = _records(n=6, sides=("l",) * 6)
    parts = np.zeros((6, SIZE, SIZE), np.uint8)
    parts[0, :4, :4], parts[0, 8:10, :4] = 5, 20          # 16 left, 8 right
    parts[1, :4, :4], parts[1, 8:10, :4] = 20, 5
    parts[2, :2, :4], parts[2, 8:10, :4] = 5, 20          # 8 and 8
    vis = np.ones((6, 42), bool)
    vis[4, :10] = False                                    # right has more
    raw.update(hand_parts=parts, keypoint_vis=vis)
    kw = dict(image_size=(SIZE, SIZE), use_wrist_coord=False)
    got = tpipe.derive_batch(raw, tpipe.PipelineConfig(**kw),
                             torch.Generator(), "cpu")["hand_side"]
    want = np.asarray(_jax_derive(raw, jpipe.PipelineConfig(**kw))[
        "hand_side"])
    np.testing.assert_array_equal(got.numpy()[:3], want[:3])
    np.testing.assert_array_equal(got.numpy()[:, 0], [1, 0, 0, 1, 0, 1])


# ------------------------------------------------------------ the system

def test_staged_lr_matches_jax():
    vals, steps = [1e-4, 1e-5, 1e-6], [10, 20]
    for s in (0, 9, 10, 19, 20, 100):
        assert tsys.staged_lr(vals, steps, s) == pytest.approx(
            float(jsys.staged_lr(vals, steps, jnp.asarray(s))))
    for name in ("HANDSEGNET", "POSENET", "LIFTING"):
        assert getattr(tsys, f"TRAIN_PARA_{name}") == getattr(
            jsys, f"TRAIN_PARA_{name}")


class _NoDropout(fnn.Module):
    """flax's Dropout with nothing dropped."""

    rate: float
    deterministic: bool = None

    def __call__(self, x):
        return x


TRAIN_CASES = [("handsegnet", "proposed"), ("posenet", "proposed")] + [
    ("lifting", v) for v in tnet.LIFTING_VARIANTS]


def _train_batch(net, seed):
    """A derived batch (noise off) of the reader flags the net trains on."""
    raw = _records(n=B, seed=seed, sides=("l", "r"))
    kw = dict(image_size=(SIZE, SIZE), use_wrist_coord=False)
    if net == "lifting":
        kw.update(crop_size=SIZE, hand_crop=True)
    return (tpipe.derive_batch(raw, tpipe.PipelineConfig(**kw),
                               torch.Generator(), "cpu"),
            _jax_derive(raw, jpipe.PipelineConfig(**kw)))


def _assert_net_close(module, params, lr, updates, what):
    want = hand3d_state_dict_from_jax(params)
    got = module.state_dict()
    assert set(got) == set(want)
    outside = total = 0
    for k, v in want.items():
        a, b = got[k].detach().numpy(), v.numpy()
        diff = np.abs(a - b)
        outside += int((diff > 2e-5 + 1e-3 * np.abs(b)).sum())
        total += b.size
        assert diff.max() <= 2 * lr * updates, f"{what} {k}: {diff.max()}"
    assert outside <= 0.005 * total, f"{what}: {outside} of {total}"


@pytest.mark.parametrize("net,variant", TRAIN_CASES)
def test_train_step_matches_jax_over_three_steps(net, variant, monkeypatch):
    """The loss of every step, then every parameter after three Adam
    updates at the subnet's first learning rate, with dropout off on both
    sides."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(tnet, "dropout", lambda x, *args: x)
    jsystem = jsys.Hand3DSystem(net=net, variant=variant, crop_size=SIZE)
    state = _jax_system(net, variant)[1]
    step = jax.jit(jsystem.make_train_step())
    system = tsys.Hand3DSystem(net, variant, crop_size=SIZE, device="cpu")
    system.module.load_state_dict(hand3d_state_dict_from_jax(state.params))
    port_step = tsys.make_hand3d_train_step(system)
    for i in range(3):
        got_batch, want_batch = _train_batch(net, 20 + i)
        state, want = step(state, want_batch)
        got = port_step(got_batch)
        np.testing.assert_allclose(float(got), float(want), rtol=2e-4,
                                   err_msg=f"step {i}")
        assert float(got) > 0
    assert system.step == int(state.step) == 3
    _assert_net_close(system.module, state.params,
                      jsystem.train_para["lr"][0], 3, f"{net} {variant}")


def test_system_state_dict_round_trip(tmp_path):
    """CheckpointManager saves the net, the Adam, the step and the dropout
    stream; a system restored from it takes the same next step; another
    net or variant is refused."""
    a = tsys.Hand3DSystem("lifting", "local", crop_size=SIZE, device="cpu",
                          seed=4)
    step_a = tsys.make_hand3d_train_step(a)
    batch = _train_batch("lifting", 30)[0]
    step_a(batch)
    ckpt = CheckpointManager(str(tmp_path), "h3d_lifting")
    ckpt.save(a, "latest")
    b = tsys.Hand3DSystem("lifting", "local", crop_size=SIZE, device="cpu",
                          seed=9)
    ckpt.restore(b, "latest")
    assert b.step == 1
    la, lb = step_a(batch), tsys.make_hand3d_train_step(b)(batch)
    assert float(la) == float(lb)
    for k, v in a.module.state_dict().items():
        assert torch.equal(v, b.module.state_dict()[k]), k
    with pytest.raises(ValueError, match="checkpoint holds"):
        ckpt.restore(tsys.Hand3DSystem("lifting", "direct", crop_size=SIZE,
                                       device="cpu"), "latest")
    with pytest.raises(ValueError, match="unknown hand3d net"):
        tsys.Hand3DSystem("posenet3d", device="cpu")


_DP_WORKER = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from mmhand_torch.hand3d import pipeline as tpipe
from mmhand_torch.hand3d import system as tsys
from mmhand_torch.parallel import init_distributed

device = init_distributed("cpu")
rank, world = dist.get_rank(), dist.get_world_size()
torch.set_num_threads(1)
rng = np.random.RandomState(0)
n, size = 4, 32
parts = np.zeros((n, size, size), np.uint8)
parts[:, 4:12, 4:12] = 5
raw = {"keypoint_xyz": rng.normal(size=(n, 42, 3)).astype(np.float32),
       "keypoint_uv": rng.uniform(2, size - 2, (n, 42, 2)).astype(np.float32),
       "cam_mat": np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
       "image": rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8),
       "hand_parts": parts, "keypoint_vis": rng.rand(n, 42) > 0.2}
cfg = tpipe.PipelineConfig(image_size=(size, size), use_wrist_coord=False)
batch = tpipe.derive_batch(raw, cfg, torch.Generator(), "cpu")
mine = {k: v[rank * n // world:(rank + 1) * n // world]
        for k, v in batch.items()}
system = tsys.Hand3DSystem("posenet", device="cpu", distributed=True)
loss = tsys.make_hand3d_train_step(system)(mine)
single = tsys.Hand3DSystem("posenet", device="cpu")
gap = 0.0
if rank == 0:
    # the ranks' mean of per-rank losses, as mmhand_tpu's pmean
    halves = []
    for r in range(world):
        part = {k: v[r * n // world:(r + 1) * n // world]
                for k, v in batch.items()}
        with torch.no_grad():
            halves.append(float(single.loss_fn(part)))
    print("LOSS", float(loss), np.mean(halves))
# the dropout streams differ by rank, the weights agree
lift = tsys.Hand3DSystem("lifting", "proposed", crop_size=size, device="cpu",
                         distributed=True)
draw = torch.rand(8, generator=lift.dropout_gen)
draws = [torch.zeros(8) for _ in range(world)]
dist.all_gather(draws, draw)
flat = torch.cat([p.detach().reshape(-1) for p in system.module.parameters()])
flats = [torch.zeros_like(flat) for _ in range(world)]
dist.all_gather(flats, flat)
if rank == 0:
    print("DRAWS_DIFFER", not torch.equal(draws[0], draws[1]))
    print("WEIGHTS_AGREE", torch.equal(flats[0], flats[1]))
dist.destroy_process_group()
'''


def test_data_parallel_step_over_two_gloo_ranks(tmp_path):
    """Two ranks of batch 2: the loss is the mean of the ranks' losses (as
    mmhand_tpu's pmean), the weights stay equal on both ranks after the
    averaged update, and each rank draws its own dropout."""
    from mmhand_torch.parallel.dryrun import launch

    worker = tmp_path / "worker.py"
    worker.write_text(_DP_WORKER)
    env = {"OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    logs = launch([str(worker)], 2, timeout=240, env=env)
    out = logs[0]
    got, want = map(float, re.search(r"LOSS (\S+) (\S+)", out).groups())
    assert got == pytest.approx(want, rel=2e-4)
    assert "DRAWS_DIFFER True" in out and "WEIGHTS_AGREE True" in out
