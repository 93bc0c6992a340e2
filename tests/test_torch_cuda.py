"""mmhand_torch's CUDA kernels against their plain versions, on the card.

Every test here but one needs a CUDA device and skips without one (the
exception checks on the CPU the Adam bound one of them uses).  The file
imports no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the other files.)
"""

import copy
import functools

import numpy as np
import pytest
import torch

from mmhand_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    OptimConfig,
    PrecisionConfig,
)
from mmhand_torch.data.loader import make_prepare_batch
from mmhand_torch.models.check_nets import (
    make_test_pose_resnet,
    pose_resnet_f64,
)
from mmhand_torch.models.layers import BatchNorm2d, BatchNorm3d, ReflectPad2d
from mmhand_torch.ops.bn_stats import (
    bn_apply_backward,
    bn_apply_backward_ref,
    bn_apply_forward,
    bn_apply_ref,
    bn_sums,
    bn_sums_backward,
    bn_sums_backward_ref,
    bn_sums_ref,
)
from mmhand_torch.eval import Evaluator, HPEJudge
from mmhand_torch.ops.heatmap import (
    CLIP_LO,
    gaussian_heatmaps,
    gaussian_heatmaps_ref,
    skip_d2,
    skipped_elements,
)
from mmhand_torch.ops.jointsmap import generate_jointsmap, generate_jointsmap_ref
from mmhand_torch.ops.reflect_pad import (
    reflect_pad,
    reflect_pad_backward_cuda,
    reflect_pad_forward_cuda,
    reflect_pad_ref,
)
from mmhand_torch.train.state import build_system
from mmhand_torch.train.step import make_eval_step, make_train_step
from mmhand_torch.utils import trace

from test_torch_reflect_pad import backward_by_gather


def launches(kernel: str) -> int:
    """The launches of ``kernel`` ('k1', 'k2', 'k2b', 'k3', 'bn_apply',
    'bn_apply_bwd', 'reflect_pad', 'reflect_pad_bwd') counted in
    ``utils.trace``."""
    return trace.counters().get(f"{kernel}.launches", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _off_clip_boundary(uv, height, width, sigma=6.0):
    """Mask of pixels whose unclipped Gaussian (float64) is more than 1e-6
    from the 0.0099 clip, where a last-bit difference cannot flip it."""
    rows = np.arange(height, dtype=np.float64)[:, None, None]
    cols = np.arange(width, dtype=np.float64)[None, :, None]
    uv = np.asarray(uv, np.float64)
    d2 = ((cols - uv[:, None, None, :, 0]) ** 2
          + (rows - uv[:, None, None, :, 1]) ** 2)
    return np.abs(np.exp(-d2 / (2 * sigma * sigma)) - CLIP_LO) > 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("batch,height,width", [(16, 256, 256), (3, 70, 90)])
def test_heatmap_kernel_matches_plain(cuda, batch, height, width):
    """atol 1e-6: the plain version on CUDA divides by 2 sigma^2 as a
    multiply by its reciprocal, the kernel divides; a last-bit difference
    before exp."""
    uv_np = np.random.RandomState(7).uniform(
        -10, width + 10, (batch, 21, 2)).astype(np.float32)
    uv = torch.from_numpy(uv_np).to(cuda)
    before = launches("k1")
    got = gaussian_heatmaps(uv, height, width, 6.0)
    torch.cuda.synchronize()
    assert launches("k1") == before + 1
    assert got.shape == (batch, height, width, 21) and got.is_cuda
    want = gaussian_heatmaps_ref(uv, height, width, 6.0)
    keep = _off_clip_boundary(uv_np, height, width)
    np.testing.assert_allclose(np.where(keep, got.cpu().numpy(), 0),
                               np.where(keep, want.cpu().numpy(), 0),
                               rtol=0, atol=1e-6)


# keypoints for K1's early-out (tests/test_torch_ops.py runs them on the CPU)
HEAT_SKIP_CASES = ["inside", "edges", "off_frame", "near_threshold"]


def _heatmap_skip_case(case, sigma, batch, height, width, seed=11):
    """(batch, 21, 2) keypoints: fractional ones inside the frame, on its
    edges and corners, off it, or placed so that pixel (30, 10) lies at d^2
    within a few ulps of the early-out threshold, on either side."""
    rng = np.random.RandomState(seed)
    size = np.array([width - 1, height - 1], np.float32)
    uv = rng.uniform(0, 1, (batch, 21, 2)) * size
    if case == "edges":
        side = rng.randint(0, 2, (batch, 21))  # the coordinate on an edge
        edge = rng.randint(0, 2, (batch, 21)) * size[side]
        np.put_along_axis(uv, side[..., None], edge[..., None], -1)
        uv[:, :4] = [[0, 0], [width - 1, 0], [0, height - 1], size]
        uv[:, 4:8] += rng.choice([-0.5, 0.5], (batch, 4, 2))
    elif case == "off_frame":
        far = rng.uniform(0.5, 40, (batch, 21))
        uv[:, :7, 0] = -far[:, :7]
        uv[:, 7:14, 0] = width - 1 + far[:, 7:14]
        uv[:, 14:, 1] = rng.choice([-1, 1], (batch, 7)) * (height + far[:, 14:])
    elif case == "near_threshold":
        t = np.float64(np.float32(skip_d2(sigma)))
        dy = np.arange(21) % int(np.sqrt(t))
        eps = rng.choice([-3e-7, -1e-7, 0.0, 1e-7, 3e-7], (batch, 21))
        uv = np.stack(np.broadcast_arrays(
            30.0 - np.sqrt(t * (1 + eps) - dy * dy), 10.0 - dy), -1)
    return torch.from_numpy(np.asarray(uv, np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", HEAT_SKIP_CASES)
@pytest.mark.parametrize("sigma", [5.0, 6.0])
@pytest.mark.parametrize("batch,height,width", [(16, 256, 256), (3, 70, 90)])
def test_heatmap_kernel_early_out(cuda, case, sigma, batch, height, width):
    """The early-out's hard cases: the kernel within 1e-6 of the plain
    version off the clip boundary, and 0 wherever it skipped, as the plain
    version is; (3, 70, 90) rows are not 16-byte multiples."""
    uv = _heatmap_skip_case(case, sigma, batch, height, width).to(cuda)
    got = gaussian_heatmaps(uv, height, width, sigma)
    torch.cuda.synchronize()
    want = gaussian_heatmaps_ref(uv.cpu(), height, width, sigma)
    skipped = skipped_elements(uv.cpu(), height, width, sigma)
    assert not bool(want[skipped].any())
    assert not bool(got.cpu()[skipped].any())
    keep = _off_clip_boundary(uv.cpu().numpy(), height, width, sigma)
    assert keep.mean() > 1 - 1e-3
    np.testing.assert_allclose(np.where(keep, got.cpu().numpy(), 0),
                               np.where(keep, want.numpy(), 0),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_heatmap_kernel_checks_its_input(cuda):
    uv = torch.zeros(2, 21, 2, device=cuda)
    with pytest.raises(TypeError):
        gaussian_heatmaps(uv.double())
    with pytest.raises(ValueError):
        gaussian_heatmaps(torch.zeros(2, 21, 3, device=cuda))
    with pytest.raises(ValueError):
        gaussian_heatmaps(uv.transpose(0, 1))
    with pytest.raises(ValueError, match="keypoints"):
        gaussian_heatmaps(torch.zeros(1, 6145, 2, device=cuda), 4, 4)


@pytest.mark.cuda
def test_prepare_batch_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(8)
    raw = {}
    for side in ("src", "tgt"):
        raw[f"{side}_image"] = rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
        raw[f"{side}_depth"] = rng.randint(0, 700, (2, 32, 32)).astype(np.uint16)
        raw[f"{side}_uv"] = rng.uniform(4, 28, (2, 21, 2)).astype(np.float32)
    got = make_prepare_batch(6.0, cuda)(raw)
    want = make_prepare_batch(6.0, "cpu")(raw)
    # CUDA divides by a Python scalar as a multiply by its reciprocal: 2 ulps
    for k in ("H1", "D1", "H2", "D2"):
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                   rtol=0, atol=2.5e-7, err_msg=k)
    for k, uv in (("P1", raw["src_uv"]), ("P2", raw["tgt_uv"])):
        keep = _off_clip_boundary(uv, 32, 32)
        np.testing.assert_allclose(np.where(keep, got[k].cpu().numpy(), 0),
                                   np.where(keep, want[k].numpy(), 0),
                                   rtol=0, atol=1e-6)


# K2's edge cases: C not a multiple of the vector width with N mod k != 0
# (N = 3 * 7 * 9 = 189; k = 2, 4 or 8), then an unaligned base (``big[1:]``
# of a C=1 tensor with H*W odd: 63 elements, 252 bytes in; a large one; a
# 5-D one), and one element at an unaligned base, fewer than the head
# before the 16-byte boundary
BN_EDGE_CASES = [((3, c, 7, 9), dtype, 0) for c in (1, 2, 3, 5, 21)
                 for dtype in (torch.float32, torch.bfloat16)]
BN_EDGE_CASES += [((5, 1, 7, 9), torch.float32, 1),
                  ((5, 1, 7, 9), torch.bfloat16, 1),
                  ((9, 3, 5, 7), torch.float16, 1),
                  ((33, 1, 127, 129), torch.float32, 1),
                  ((3, 21, 5, 7, 9), torch.float32, 1),
                  ((2, 1, 1, 1), torch.float32, 1),
                  ((2, 1, 1, 1), torch.bfloat16, 1)]


def _layout(shape):
    return torch.channels_last if len(shape) == 4 else torch.channels_last_3d


def _bn_input(shape, dtype, offset, seed, device):
    """A channels_last (5-D: channels_last_3d) tensor of ``shape`` from a
    seed, or with ``offset`` the tensor without its first ``offset`` images
    (a view at an offset), and the generator, to draw more from."""
    gen = torch.Generator(device=device).manual_seed(seed)
    big = (torch.randn(shape, generator=gen, device=device) * 1.5 + 0.3).to(
        dtype).contiguous(memory_format=_layout(shape))
    x = big[offset:]
    assert x.is_contiguous(memory_format=_layout(shape))
    return x, gen


def _hold_bn_kernels(x, g1, g2):
    """K2 on ``x`` against the plain sums: f32 sums in another order, held
    relative to sum |x| and sum x^2 at 1e-5.  K2b against the plain
    formula: the same operations in the same order, so bit for bit.
    Returns K2's sums and K2b's output."""
    s1, s2 = bn_sums(x)
    dx = bn_sums_backward(x, g1, g2)
    r1, r2 = bn_sums_ref(x)
    axes = (0,) + tuple(range(2, x.dim()))
    assert float(((s1 - r1).abs() / x.float().abs().sum(axes)).max()) <= 1e-5
    assert float(((s2 - r2).abs() / r2).max()) <= 1e-5
    assert dx.dtype == x.dtype and dx.is_contiguous(
        memory_format=_layout(x.shape))
    assert torch.equal(dx, bn_sums_backward_ref(x, g1, g2))
    return s1, s2, dx


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset", [
    ((16, 64, 256, 256), torch.bfloat16, 0),  # the train step's largest site
    ((16, 64, 256, 256), torch.float16, 0),   # the same in the fp16 slice
    ((16, 512, 64, 64), torch.bfloat16, 0),   # a PATBlock attention stream
    ((4, 128, 32, 32), torch.float16, 0),
    ((3, 29, 37, 41), torch.float32, 0)]      # ragged N and C
    + BN_EDGE_CASES)
def test_bn_kernels_match_plain(cuda, shape, dtype, offset):
    """K2 and K2b against the plain versions (``_hold_bn_kernels``), one
    launch each; K2b within one rounding of autograd's backward of the
    plain sums."""
    x, gen = _bn_input(shape, dtype, offset, 3, cuda)
    if offset:
        assert x.data_ptr() % 16
    g1 = torch.randn(shape[1], generator=gen, device=cuda)
    g2 = torch.randn(shape[1], generator=gen, device=cuda)
    before = (launches("k2"), launches("k2b"))
    s1, s2, dx = _hold_bn_kernels(x, g1, g2)
    assert (launches("k2"), launches("k2b")) == (
        before[0] + 1, before[1] + 1)
    # autograd of the plain sums adds 2 g2 x as g2 x + g2 x: one rounding
    # of the working type from K2b at most
    xr = x.detach().requires_grad_()
    torch.autograd.backward(bn_sums_ref(xr), (g1, g2))
    ch = (1, -1) + (1,) * (x.dim() - 2)
    tol = torch.finfo(dtype).eps * (g1.abs().view(ch)
                                    + 2 * (g2.view(ch) * x.float()).abs())
    assert float(((dx.float() - xr.grad.float()).abs() - tol).max()) <= 0.0
    again = bn_sums(x)  # no atomics: the same sums on every run
    assert torch.equal(again[0], s1) and torch.equal(again[1], s2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset", [
    ((16, 256, 64, 64), torch.bfloat16, 0), ((32, 1, 128, 128), torch.float32, 0)]
    + BN_EDGE_CASES)
def test_bn_sums_bit_identical_across_calls(cuda, shape, dtype, offset):
    """Two calls of K2 on one input give the same bits: whichever block
    finishes last, the partials are added in one fixed order."""
    x, _ = _bn_input(shape, dtype, offset, 5, cuda)
    first = [t.clone() for t in bn_sums(x)]
    for _ in range(2):
        again = bn_sums(x)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset", [
    ((16, 256, 64, 64), torch.bfloat16, 0), ((8, 1, 256, 256), torch.float32, 0),
    ((5, 1, 7, 9), torch.float32, 1), ((3, 21, 7, 9), torch.bfloat16, 0)])
def test_bn_sums_in_cuda_graph_equal_eager(cuda, shape, dtype, offset):
    """K2 captured three times over in a CUDA graph and replayed three
    times equals eager K2 bit for bit every time: each launch starts from
    tickets the one before reset, with no memset in the graph."""
    x, _ = _bn_input(shape, dtype, offset, 6, cuda)
    want = [t.clone() for t in bn_sums(x)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bn_sums(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = launches("k2")
    with torch.cuda.graph(graph):
        outs = [bn_sums(x) for _ in range(3)]
    assert launches("k2") == before + 3
    for _ in range(3):
        for o in outs:
            o[0].zero_()
            o[1].zero_()
        graph.replay()
        torch.cuda.synchronize()
        for s1, s2 in outs:
            assert torch.equal(s1, want[0]) and torch.equal(s2, want[1])
    again = bn_sums(x)
    assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((16, 64, 256, 256), torch.bfloat16),  # 528 blocks over 66 tiles
    ((16, 256, 64, 64), torch.bfloat16),
    ((32, 1, 128, 128), torch.float32)])   # one tile, 256 chunks
def test_bn_sums_on_two_streams_at_once(cuda, shape, dtype):
    """K2 on two streams with no wait between them, 8 launches a stream
    per round, 10 rounds: every result equals the eager sums of its input
    bit for bit, and those the plain sums at 1e-5, so no launch took
    another's tickets.  The inputs share one plan, so the launches would
    count on the same tickets if the streams shared them."""
    xs = [_bn_input(shape, dtype, 0, seed, cuda)[0] for seed in (11, 12)]
    want = [[t.clone() for t in bn_sums(x)] for x in xs]
    for x, (s1, s2) in zip(xs, want):
        r1, r2 = bn_sums_ref(x)
        assert float(((s1 - r1).abs() / x.float().abs().sum((0, 2, 3))).max()) <= 1e-5
        assert float(((s2 - r2).abs() / r2).max()) <= 1e-5
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(10):
        outs = [[], []]
        for _ in range(8):  # issued in turns, so the two queues interleave
            for i, (s, x) in enumerate(zip(streams, xs)):
                with torch.cuda.stream(s):
                    outs[i].append(bn_sums(x))
        torch.cuda.synchronize()
        for i in range(2):
            for s1, s2 in outs[i]:
                assert torch.equal(s1, want[i][0]) and torch.equal(s2, want[i][1])
    again = [bn_sums(x) for x in xs]
    for (s1, s2), w in zip(again, want):
        assert torch.equal(s1, w[0]) and torch.equal(s2, w[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset", BN_EDGE_CASES)
def test_bn_backward_equals_plain_at_edge_cases(cuda, shape, dtype, offset):
    """K2b, unchanged beside the new K2, still equals the plain formula bit
    for bit at K2's edge cases, the unaligned base included."""
    x, gen = _bn_input(shape, dtype, offset, 7, cuda)
    g1 = torch.randn(shape[1], generator=gen, device=cuda)
    g2 = torch.randn(shape[1], generator=gen, device=cuda)
    dx = bn_sums_backward(x, g1, g2)
    assert dx.is_contiguous(memory_format=_layout(shape))
    assert torch.equal(dx, bn_sums_backward_ref(x, g1, g2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_sums_on_empty_view_at_unaligned_base(cuda, dtype):
    """An empty view at an unaligned base gives zero sums in one launch,
    and K2b an empty gradient."""
    x, _ = _bn_input((2, 3, 1, 1), dtype, 1, 8, cuda)
    empty = x[1:]
    assert empty.numel() == 0
    before = launches("k2")
    s1, s2 = bn_sums(empty)
    assert launches("k2") == before + 1
    assert torch.equal(s1, torch.zeros(3, device=cuda))
    assert torch.equal(s2, torch.zeros(3, device=cuda))
    dx = bn_sums_backward(empty, torch.ones(3, device=cuda),
                          torch.ones(3, device=cuda))
    assert dx.shape == empty.shape


@pytest.mark.cuda
def test_bn_kernels_refuse_other_layouts(cuda):
    x = torch.randn(2, 8, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        bn_sums(x)
    with pytest.raises(ValueError, match="channels_last"):
        bn_sums_backward(x, torch.zeros(8, device=cuda),
                         torch.zeros(8, device=cuda))
    with pytest.raises(TypeError):
        bn_sums(x.double().contiguous(memory_format=torch.channels_last))


# the normalize's cases: the GAN step's four site shapes in bf16, the
# largest in fp16 and f32, the voxel and depth nets' C=1 and C=21 sites
# (2-D and 5-D) and their largest 5-D site, and
# views at bases off a 16-byte boundary (``offset`` elements into a flat
# buffer): ragged C, 5-D, and a C that is a multiple of the vector width
BN_APPLY_CASES = [((16, 64, 256, 256), torch.bfloat16, 0),
                  ((16, 128, 128, 128), torch.bfloat16, 0),
                  ((16, 256, 64, 64), torch.bfloat16, 0),
                  ((16, 512, 64, 64), torch.bfloat16, 0),
                  ((16, 64, 256, 256), torch.float16, 0),
                  ((16, 64, 256, 256), torch.float32, 0),
                  ((32, 1, 128, 128), torch.float32, 0),
                  ((8, 1, 256, 256), torch.float32, 0),
                  ((8, 1, 64, 64, 64), torch.float32, 0),
                  ((8, 21, 64, 64), torch.bfloat16, 0),
                  ((8, 21, 256, 256), torch.float32, 0),
                  ((8, 16, 64, 64, 64), torch.float32, 0),
                  ((8, 16, 64, 64, 64), torch.bfloat16, 0),
                  ((5, 1, 7, 9), torch.bfloat16, 1),
                  ((9, 3, 5, 7), torch.float16, 1),
                  ((4, 64, 9, 11), torch.bfloat16, 3),
                  ((3, 21, 5, 7, 9), torch.float32, 1)]


def _apply_inputs(shape, dtype, offset, seed, device):
    """x in channels_last (channels_last_3d for 5-D) at ``offset`` elements
    into a flat buffer, dy in the same layout, the plain moments of x and a
    BatchNorm's weight and bias, from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    numel = int(np.prod(shape))
    dims = (shape[0],) + tuple(shape[2:]) + (shape[1],)
    flat = (torch.randn(offset + numel, generator=gen, device=device) * 1.5
            + 0.3).to(dtype)
    x = flat[offset:].view(dims).movedim(-1, 1)
    dy = torch.randn(dims, generator=gen, device=device).to(dtype).movedim(-1, 1)
    layout = torch.channels_last if len(shape) == 4 else torch.channels_last_3d
    assert x.is_contiguous(memory_format=layout)
    assert bool(x.data_ptr() % 16) == bool(offset * x.element_size() % 16)
    s1, s2 = bn_sums_ref(x)
    n = numel // shape[1]
    weight = 1 + 0.02 * torch.randn(shape[1], generator=gen, device=device)
    bias = 0.1 * torch.randn(shape[1], generator=gen, device=device)
    return x, dy, s1 / n, s2 / n, weight, bias, layout


def _channel(v, x):
    return v.view((1, -1) + (1,) * (x.dim() - 2))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset", BN_APPLY_CASES)
def test_bn_apply_kernels_match_plain(cuda, shape, dtype, offset):
    """bn_apply_kernel and bn_apply_backward_kernel against the plain
    version on the card, in the working type.  y and dx: the same f32
    operations in the same order, held within two roundings of the working
    type of the terms.  The per-channel gradients come from f32 sums taken in
    another order: sum dy and sum dy (x - mean) held at 1e-5 of sum |dy|
    and sum |dy (x - mean)|, carried through each gradient's formula."""
    x, dy, mean, mean_sq, weight, bias, layout = _apply_inputs(
        shape, dtype, offset, 17, cuda)
    eps = 1e-5
    before = (launches("bn_apply"), launches("bn_apply_bwd"))
    y = bn_apply_forward(x, mean, mean_sq, weight, bias, eps)
    dx, d_mean, d_mean_sq, d_weight, d_bias = bn_apply_backward(
        dy, x, mean, mean_sq, weight, eps)
    torch.cuda.synchronize()
    assert (launches("bn_apply"), launches("bn_apply_bwd")) == (
        before[0] + 1, before[1] + 1)
    for t in (y, dx):
        assert t.dtype == dtype and t.shape == x.shape
        assert t.is_contiguous(memory_format=layout)
    unit = torch.finfo(dtype).eps
    r = torch.rsqrt(torch.clamp(mean_sq - mean * mean, min=0.0) + eps)
    scale = _channel(r * weight, x)
    xm = x.float() - _channel(mean, x)
    y_ref = bn_apply_ref(x, mean, mean_sq, weight, bias, eps)
    y_tol = 2 * unit * ((xm * scale).abs() + _channel(bias, x).abs())
    assert bool(((y.float() - y_ref.float()).abs() <= y_tol).all())
    want = bn_apply_backward_ref(dy, x, mean, mean_sq, weight, eps)
    g = dy.float()
    dx_tol = 2 * unit * (g * scale).abs()
    assert bool(((dx.float() - want[0].float()).abs() <= dx_tol).all())
    axes = (0,) + tuple(range(2, x.dim()))
    sum_abs_dy = g.abs().sum(axes)
    sum_abs_b = (g * xm).abs().sum(axes)
    f32 = torch.finfo(torch.float32).eps
    d_var_scale = 0.5 * weight.abs() * r ** 3
    bounds = (
        1e-5 * ((r * weight).abs() * sum_abs_dy
                + 2 * mean.abs() * d_var_scale * sum_abs_b),
        1e-5 * d_var_scale * sum_abs_b,
        1e-5 * r * sum_abs_b,
        1e-5 * sum_abs_dy)
    for name, got, ref, bound in zip(
            ("d_mean", "d_mean_sq", "d_weight", "d_bias"),
            (d_mean, d_mean_sq, d_weight, d_bias), want[1:], bounds):
        assert got.dtype == torch.float32 and got.shape == (shape[1],), name
        excess = (got - ref).abs() - bound - 8 * f32 * ref.abs()
        assert float(excess.max()) <= 0.0, (name, float(excess.max()))


@pytest.mark.cuda
def test_bn_apply_backward_bit_identical_across_calls(cuda):
    """The backward's per-channel sums are added in one fixed order,
    whichever block finishes last: two calls give the same bits."""
    x, dy, mean, mean_sq, weight, _, _ = _apply_inputs(
        (16, 256, 64, 64), torch.bfloat16, 0, 18, cuda)
    first = [t.clone() for t in bn_apply_backward(dy, x, mean, mean_sq,
                                                  weight, 1e-5)]
    for _ in range(2):
        again = bn_apply_backward(dy, x, mean, mean_sq, weight, 1e-5)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.cuda
def test_bn_apply_refuses_other_layouts(cuda):
    x = torch.randn(2, 8, 4, 4, device=cuda)
    c = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        bn_apply_forward(x, c, c, c, c, 1e-5)
    with pytest.raises(ValueError, match="channels_last"):
        bn_apply_backward(x, x, c, c, c, 1e-5)
    with pytest.raises(TypeError):
        bn_apply_forward(x.double().contiguous(memory_format=torch.channels_last),
                         c, c, c, c, 1e-5)


@pytest.mark.cuda
def test_bn_apply_counts_one_launch_per_site(cuda):
    """Through a toy GAN train step, an eval-mode generator and a no-grad
    train-mode forward: one forward launch per train-mode BatchNorm call,
    one backward launch per call whose input needs a gradient, K2 and K2b
    once each beside them, and none in eval mode."""
    cfg = Config(model=ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=2,
                                   n_layers_d=2),
                 optim=OptimConfig(pool_size=0),
                 data=DataConfig(dataset="synthetic"))
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        system = build_system(cfg, cuda)
    calls = {"train": 0, "grad": 0}

    def record(module, args):
        if module.training:
            calls["train"] += 1
            calls["grad"] += int(torch.is_grad_enabled()
                                 and args[0].requires_grad)

    nets = (system.generator, system.d_pb, system.d_pp)
    hooks = [m.register_forward_pre_hook(record) for net in nets
             for m in net.modules() if isinstance(m, (BatchNorm2d, BatchNorm3d))]
    rng = np.random.RandomState(10)
    batch = {k: torch.from_numpy(rng.uniform(
        -1 if k[0] != "P" else 0, 1, (2, 32, 32, 21 if k[0] == "P" else 3)
    ).astype(np.float32)).to(cuda) for k in ("H1", "P1", "D1", "H2", "P2", "D2")}
    g_in = (batch["H1"], torch.cat([batch["P1"], batch["P2"]], -1),
            torch.cat([batch["D1"], batch["D2"]], -1))
    names = ("bn_apply", "bn_apply_bwd", "k2", "k2b")
    try:
        before = [launches(k) for k in names]
        make_train_step(system)(batch, 2e-4)
        torch.cuda.synchronize()
        counted = [launches(k) - b for k, b in zip(names, before)]
        assert calls["train"] > 0 and calls["grad"] > 0
        assert counted == [calls["train"], calls["grad"]] * 2, (counted, calls)
        step_calls = dict(calls)
        before = [launches(k) for k in names]
        with torch.no_grad():
            system.generator.train()(g_in)
        counted = [launches(k) - b for k, b in zip(names, before)]
        assert counted == [calls["train"] - step_calls["train"], 0] * 2
        before = [launches(k) for k in names]
        system.generator.eval()(g_in)
        torch.cuda.synchronize()
        assert [launches(k) - b for k, b in zip(names, before)] == [0] * 4
    finally:
        for h in hooks:
            h.remove()


@pytest.mark.cuda
def test_batch_norm_train_pass_uses_bn_apply(cuda):
    """A BatchNorm2d train-mode forward and backward in bf16 on the card
    against today's op sequence (the moments, then the f32 normalize that
    autograd differentiates) on the same card: output and input gradient
    within two roundings of bf16, weight and bias gradients within f32
    sums, the running statistics equal."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    x = (torch.randn(8, 64, 32, 32, generator=gen, device=cuda) * 1.5 + 0.3
         ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = torch.randn(x.shape, generator=gen, device=cuda).to(torch.bfloat16)
    bn = BatchNorm2d(64).to(cuda)
    with torch.no_grad():
        bn.weight.normal_(1.0, 0.02, generator=gen)
        bn.bias.normal_(0.0, 0.1, generator=gen)
    ref = copy.deepcopy(bn)
    xr = x.clone().requires_grad_()
    y = bn(xr)
    (y * w).sum().backward()
    xo = x.clone().requires_grad_()
    n = xo.numel() // 64
    s1, s2 = bn_sums_ref(xo)
    mean, mean_sq = s1 / n, s2 / n
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        ref.running_mean.lerp_(mean, ref.momentum)
        ref.running_var.lerp_(var, ref.momentum)
    scale = torch.rsqrt(var + ref.eps) * ref.weight
    yo = ((xo.float() - mean.view(-1, 1, 1)) * scale.view(-1, 1, 1)
          + ref.bias.view(-1, 1, 1)).to(torch.bfloat16)
    (yo * w).sum().backward()
    unit = torch.finfo(torch.bfloat16).eps
    assert float((y.float() - yo.float()).abs().max()) <= 2 * unit * float(
        yo.float().abs().max())
    gap = (xr.grad.float() - xo.grad.float()).norm() / xo.grad.float().norm()
    assert float(gap) <= 2 * unit, float(gap)
    # f32 sums in two orders: at 1e-5 of the sums of |terms|
    g, xm = w.float(), x.float() - mean.view(-1, 1, 1)
    bound_b = 1e-5 * g.abs().sum((0, 2, 3))
    bound_w = 1e-5 * (g * xm).abs().sum((0, 2, 3)) * torch.rsqrt(var + ref.eps)
    assert bool(((bn.bias.grad - ref.bias.grad).abs() <= bound_b).all())
    assert bool(((bn.weight.grad - ref.weight.grad).abs() <= bound_w).all())
    # K2's moments against the plain sums', lerped by 0.1
    for a, b in ((bn.running_mean, ref.running_mean),
                 (bn.running_var, ref.running_var)):
        assert float((a - b).abs().max()) <= 2e-6


# the flagship step's pad sites at batch 16: G's f32 stems (3, 42, 6
# channels) and D's (24, 6) at 256 px, pad 3; the PATBlocks' and
# ResnetBlocks' 256 and 512 channels at 64 px, pad 1, bf16; the up path's 64
# channels at 256 px, pad 3; the blocks' site in f16 and f32; then the
# edges: mirrors that overlap (p = H - 1), a ragged C, odd sizes, and bases
# ``offset`` elements off a 16-byte boundary (narrower vectors)
REFLECT_PAD_CASES = [((16, 3, 256, 256), torch.float32, 3, 0),
                     ((16, 42, 256, 256), torch.float32, 3, 0),
                     ((16, 6, 256, 256), torch.float32, 3, 0),
                     ((16, 24, 256, 256), torch.float32, 3, 0),
                     ((16, 256, 64, 64), torch.bfloat16, 1, 0),
                     ((16, 512, 64, 64), torch.bfloat16, 1, 0),
                     ((16, 64, 256, 256), torch.bfloat16, 3, 0),
                     ((16, 256, 64, 64), torch.float16, 1, 0),
                     ((16, 256, 64, 64), torch.float32, 1, 0),
                     ((3, 5, 4, 4), torch.bfloat16, 3, 0),
                     ((2, 51, 17, 9), torch.float16, 3, 0),
                     ((2, 7, 5, 11), torch.float32, 2, 0),
                     ((2, 256, 8, 8), torch.bfloat16, 1, 1),
                     ((2, 24, 9, 7), torch.float32, 3, 2),
                     ((2, 64, 6, 6), torch.float16, 1, 4)]


def _pad_inputs(shape, dtype, p, offset, seed, device):
    """x in channels_last at ``offset`` elements into a flat buffer, and a
    gradient of the padded output in channels_last at the same offset."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, c, h, w = shape

    def nhwc(hh, ww):
        n = b * hh * ww * c
        flat = torch.randn(offset + n, generator=gen, device=device).to(dtype)
        return flat[offset:].view(b, hh, ww, c).permute(0, 3, 1, 2)

    return nhwc(h, w), nhwc(h + 2 * p, w + 2 * p)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,p,offset", REFLECT_PAD_CASES)
def test_reflect_pad_kernels_match_plain(cuda, shape, dtype, p, offset):
    """reflect_pad_kernel equals ATen's pad bit for bit; the backward
    equals its mirror's f32 sums on the card bit for bit, lies within one
    rounding of the working type (and f32 sums of at most 9 terms) of
    autograd of the pad in float64, and repeats bit for bit; both come out
    channels_last, one launch each."""
    x, dy = _pad_inputs(shape, dtype, p, offset, 21, cuda)
    before = (launches("reflect_pad"), launches("reflect_pad_bwd"))
    y = reflect_pad_forward_cuda(x, p)
    dx = reflect_pad_backward_cuda(dy, p)
    torch.cuda.synchronize()
    assert (launches("reflect_pad"), launches("reflect_pad_bwd")) == (
        before[0] + 1, before[1] + 1)
    assert y.shape == dy.shape and dx.shape == x.shape
    for t in (y, dx):
        assert t.dtype == dtype
        assert t.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, reflect_pad_ref(x, p))
    assert torch.equal(dx, backward_by_gather(dy, p))
    assert torch.equal(reflect_pad_backward_cuda(dy, p), dx)
    exact = torch.zeros(x.shape, dtype=torch.float64, device=cuda,
                        requires_grad=True)
    total = torch.zeros_like(exact, requires_grad=True)
    reflect_pad_ref(exact, p).backward(dy.double())
    reflect_pad_ref(total, p).backward(dy.double().abs())
    bound = (torch.finfo(dtype).eps / 2 * exact.grad.abs()
             + 5 * torch.finfo(torch.float32).eps * total.grad)
    assert bool(((dx.double() - exact.grad).abs() <= bound).all())


@pytest.mark.cuda
def test_reflect_pad_refuses_what_it_does_not_take(cuda):
    x = torch.randn(2, 8, 5, 6, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        reflect_pad_forward_cuda(x, 1)
    with pytest.raises(ValueError, match="channels_last"):
        reflect_pad_backward_cuda(x, 1)
    x = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="below H and W"):
        reflect_pad_forward_cuda(x, 5)
    with pytest.raises(ValueError, match="below H and W"):
        reflect_pad_backward_cuda(x, 2)
    with pytest.raises(TypeError):
        reflect_pad_forward_cuda(x.double(), 1)
    with pytest.raises(ValueError, match="device"):
        reflect_pad_forward_cuda(x.cpu(), 1)


@pytest.mark.cuda
def test_reflect_pad_counts_one_launch_per_site(cuda):
    """Through a toy GAN train step and an eval-mode generator: one forward
    launch per ReflectPad2d call, one backward launch per call whose input
    needs a gradient.  A CUDA input the kernels do not take (NCHW, a slice
    that is not channels_last, float64) raises, and launches nothing."""
    cfg = Config(model=ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=2,
                                   n_layers_d=2),
                 optim=OptimConfig(pool_size=0),
                 data=DataConfig(dataset="synthetic"))
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        system = build_system(cfg, cuda)
    calls = {"all": 0, "grad": 0}

    def record(module, args):
        calls["all"] += 1
        calls["grad"] += int(torch.is_grad_enabled() and args[0].requires_grad)

    nets = (system.generator, system.d_pb, system.d_pp)
    hooks = [m.register_forward_pre_hook(record) for net in nets
             for m in net.modules() if isinstance(m, ReflectPad2d)]
    rng = np.random.RandomState(12)
    batch = {k: torch.from_numpy(rng.uniform(
        -1 if k[0] != "P" else 0, 1, (2, 32, 32, 21 if k[0] == "P" else 3)
    ).astype(np.float32)).to(cuda) for k in ("H1", "P1", "D1", "H2", "P2", "D2")}
    g_in = (batch["H1"], torch.cat([batch["P1"], batch["P2"]], -1),
            torch.cat([batch["D1"], batch["D2"]], -1))
    names = ("reflect_pad", "reflect_pad_bwd")
    try:
        before = [launches(k) for k in names]
        make_train_step(system)(batch, 2e-4)
        torch.cuda.synchronize()
        counted = [launches(k) - b for k, b in zip(names, before)]
        assert calls["grad"] > 0, calls
        assert counted == [calls["all"], calls["grad"]], (counted, calls)
        step_calls = calls["all"]
        before = [launches(k) for k in names]
        with torch.inference_mode():
            system.generator.eval()(g_in)
        torch.cuda.synchronize()
        counted = [launches(k) - b for k, b in zip(names, before)]
        assert counted == [calls["all"] - step_calls, 0]
        before = [launches(k) for k in names]
        nchw = torch.randn(2, 8, 5, 6, device=cuda, requires_grad=True)
        small = torch.randn(2, 8, 3, 6, device=cuda).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        for x in (nchw, small[..., :4], small.double()):
            with pytest.raises((ValueError, TypeError)):
                reflect_pad(x, 1)
        assert [launches(k) - b for k, b in zip(names, before)] == [0, 0]
    finally:
        for h in hooks:
            h.remove()


@pytest.mark.cuda
def test_toy_train_step_on_card_matches_cpu(cuda):
    """Two toy steps from the same weights and batches, f32 with TF32 off:
    losses within the tests' 2e-4 against JAX, parameters as
    tests/test_torch_train.py holds them against JAX (Adam lets f32
    rounding decide the update of elements whose gradient is near zero)."""
    cfg = Config(model=ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=2,
                                   n_layers_d=2, use_dropout_g=False,
                                   use_dropout_d=False),
                 optim=OptimConfig(pool_size=0),
                 data=DataConfig(dataset="synthetic"),
                 precision=PrecisionConfig(compute_dtype="float32"))
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        on_cpu = build_system(cfg, "cpu")
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        on_card = build_system(cfg, cuda)
    rng = np.random.RandomState(9)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for _ in range(2):
            batch = {k: torch.from_numpy(rng.uniform(
                -1 if k[0] != "P" else 0, 1, (2, 32, 32, 21 if k[0] == "P"
                                              else 3)).astype(np.float32))
                for k in ("H1", "P1", "D1", "H2", "P2", "D2")}
            want = make_train_step(on_cpu)(batch, 2e-4)
            got = make_train_step(on_card)(
                {k: v.to(cuda) for k, v in batch.items()}, 2e-4)
            for k, v in want.items():
                np.testing.assert_allclose(float(got[k]), float(v), rtol=2e-4,
                                           atol=2e-4, err_msg=k)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    _assert_nets_agree(on_card, on_cpu, 2, 2e-4)


def _assert_nets_agree(got, want, updates: int, lr: float) -> None:
    """The three nets of two GAN systems after ``updates`` Adam updates
    each agree by ``parallel.dryrun.params_agree``."""
    from mmhand_torch.parallel.dryrun import params_agree

    for name in ("generator", "d_pb", "d_pp"):
        ok, line = params_agree(getattr(got, name).state_dict(),
                                getattr(want, name).state_dict(), updates, lr)
        assert ok, f"{name}: {line}"


def _state_gap(a, b) -> tuple[bool, float]:
    """(every leaf equal, max |a - b| over the floating-point tensors) of two
    state trees of one structure."""
    if isinstance(b, dict):
        gaps = [_state_gap(a[k], b[k]) for k in b]
    elif isinstance(b, (list, tuple)):
        gaps = [_state_gap(x, y) for x, y in zip(a, b)]
    elif isinstance(b, torch.Tensor):
        gap = (float((a.cpu().double() - b.cpu().double()).abs().max())
               if b.is_floating_point() and b.numel() else 0.0)
        return torch.equal(a.cpu(), b.cpu()), gap
    else:
        return a == b, 0.0
    return all(g[0] for g in gaps), max([g[1] for g in gaps], default=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["zero", "reflect"])
def test_toy_resume_on_card_equals_unbroken_run(cuda, padding, tmp_path,
                                                record_property):
    """Toy size on the card, f32 with TF32 off, deterministic cuDNN and
    torch's deterministic algorithms (warn only), dropout and pools on: 3
    steps, a save, a fresh system restored, 3 more steps, against 6 steps
    without a break, twice.  The random streams and the step match
    exactly; the rest bit for bit wherever the two unbroken runs agree, and
    else as the toy step holds the card against the CPU.  The ops torch
    names as having no deterministic CUDA implementation are recorded (the
    reflect pad's backward sums with atomics)."""
    import warnings

    from mmhand_torch.utils.checkpoint import CheckpointManager

    cfg = Config(model=ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=2,
                                   n_layers_d=2, padding_type=padding),
                 optim=OptimConfig(pool_size=4),
                 data=DataConfig(dataset="synthetic"),
                 precision=PrecisionConfig(compute_dtype="float32"))
    lr = cfg.optim.lr
    rng = np.random.RandomState(0)
    batches = [{k: torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, c)).astype(
        np.float32)).to(cuda) for k, c in (("H1", 3), ("P1", 21), ("D1", 3),
                                           ("H2", 3), ("P2", 21), ("D2", 3))}
               for _ in range(6)]
    ckpt = CheckpointManager(str(tmp_path), "toy")
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs = []
            for _ in range(2):
                system = build_system(cfg, cuda)
                step = make_train_step(system)
                runs.append(([step(b, lr) for b in batches], system))
            system = build_system(cfg, cuda)
            step = make_train_step(system)
            metrics = [step(b, lr) for b in batches[:3]]
            ckpt.save(system, "latest")
            system = build_system(cfg, cuda)
            ckpt.restore(system, "latest")
            step = make_train_step(system)
            metrics += [step(b, lr) for b in batches[3:]]
    finally:
        torch.use_deterministic_algorithms(False)
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    record_property("nondeterministic", sorted({
        str(w.message).split(" does not have")[0] for w in caught
        if "deterministic implementation" in str(w.message)}))
    (want, unbroken), (again, twice) = runs
    rest, got = unbroken.state_dict(), system.state_dict()
    assert got["step"] == rest["step"]
    for key in ("rng_pool", "rng_cuda", "rng_cpu"):
        assert torch.equal(got["rank"][key], rest["rank"][key]), key
    same, gap = _state_gap((metrics, got), (want, rest))
    same2, gap2 = _state_gap((again, twice.state_dict()), (want, rest))
    record_property("resumed_gap", gap)
    record_property("unbroken_gap", gap2)
    assert same or not same2, f"the unbroken runs agree, the resumed one by {gap}"
    for m, w in zip(metrics, want):
        for k, v in w.items():
            np.testing.assert_allclose(float(m[k]), float(v), rtol=2e-4,
                                       atol=2e-4, err_msg=k)
    _assert_nets_agree(system, unbroken, 6, lr)


def _profiled(fn):
    """``fn()`` under a host and device profiler, after a warm-up call;
    returns the program's spans and the profiler's events of that call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        spans = trace.spans()
    finally:
        trace.clear()
    return spans, list(prof.profiler.kineto_results.events())


def _launched_in(spans, events, kernel_name):
    """Each device kernel whose name holds ``kernel_name``, with the host
    call that launched it (same correlation id) and the spans whose
    converted bounds enclose that call."""
    cuda_type = torch.autograd.DeviceType.CUDA
    # the runtime and driver calls (cudaLaunchKernel, cuLaunchKernel, ...)
    calls = {e.correlation_id(): e for e in events
             if e.device_type() != cuda_type and e.name().startswith("cu")}
    out = []
    for k in events:
        if (k.device_type() == cuda_type and not k.is_user_annotation()
                and kernel_name in k.name()):
            call = calls.get(k.correlation_id())
            inside = [] if call is None else [
                s for s in spans
                if s.start_ns <= call.start_ns() <= call.end_ns() <= s.end_ns]
            out.append((k, call, inside))
    return out


@pytest.mark.cuda
def test_program_spans_enclose_their_kernels(cuda, record_property):
    """On the profiler's clock: every K2 launch of a toy GAN step lies inside
    exactly one of its ``g_phase`` and ``d_phase`` spans and runs after that
    span began; every kernel of an eval step is launched inside its
    ``gen.forward`` span; a phase's CUDA-event time covers its kernels."""
    cfg = Config(model=ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=1,
                                   n_layers_d=1),
                 optim=OptimConfig(pool_size=2),
                 data=DataConfig(dataset="synthetic"),
                 precision=PrecisionConfig(compute_dtype="float32"))
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        system = build_system(cfg, cuda)
    step = make_train_step(system)
    rng = np.random.RandomState(3)
    batch = {k: torch.from_numpy(rng.uniform(
        0, 1, (2, 32, 32, 21 if k[0] == "P" else 3)).astype(np.float32)
    ).to(cuda) for k in ("H1", "P1", "D1", "H2", "P2", "D2")}
    spans, events = _profiled(lambda: step(batch, 2e-4))
    phases = [s for s in spans if s.name in ("g_phase", "d_phase")]
    assert [s.name for s in sorted(phases, key=lambda s: s.start_ns)] == [
        "g_phase", "d_phase", "d_phase"]
    found = _launched_in(phases, events, "bn_sums_kernel")
    assert found and all(call is not None for _, call, _ in found)
    margins, per_phase = [], {s.id: [] for s in phases}
    for k, call, inside in found:
        assert len(inside) == 1, (call.start_ns(), [(s.name, s.start_ns,
                                                     s.end_ns) for s in phases])
        (s,) = inside
        assert k.start_ns() >= s.start_ns
        margins.append(min(call.start_ns() - s.start_ns,
                           s.end_ns - call.end_ns()))
        per_phase[s.id].append(k)
    assert all(per_phase.values())
    for s in phases:
        ks = per_phase[s.id]
        extent_ms = (max(k.end_ns() for k in ks)
                     - min(k.start_ns() for k in ks)) / 1e6
        record_property(f"{s.name}_{s.id}_device_ms", s.device_ms)
        record_property(f"{s.name}_{s.id}_k2_extent_ms", extent_ms)
        assert s.device_ms >= 0.95 * extent_ms
    record_property("k2_launches", len(found))
    record_property("least_margin_us", min(margins) / 1e3)

    g = system.generator
    spans, events = _profiled(lambda: make_eval_step(g)(batch))
    (forward,) = [s for s in spans if s.name == "gen.forward"]
    found = _launched_in([forward], events, "")
    assert found and all(call is not None and inside == [forward]
                         for _, call, inside in found)
    assert min(k.start_ns() for k, _, _ in found) >= forward.start_ns
    record_property("gen_forward_kernels", len(found))
    record_property("gen_forward_device_ms", forward.device_ms)


@pytest.mark.cuda
def test_train_state_on_card_restores_tensor_for_tensor(cuda, tmp_path):
    """A train state saved from the card and loaded with map_location onto
    the card: nets, Adams, pools, random streams, scales and step equal the
    saved ones, and a step runs after the restore."""
    from mmhand_torch.utils.checkpoint import CheckpointManager

    cfg = Config(model=ModelConfig(fine_size=32, ngf=8, ndf=8, g_n_blocks=1,
                                   n_layers_d=1),
                 optim=OptimConfig(pool_size=3),
                 data=DataConfig(dataset="synthetic"),
                 precision=PrecisionConfig(compute_dtype="float16",
                                           loss_scaling=True))
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        system = build_system(cfg, cuda)
    rng = np.random.RandomState(4)
    batch = {k: torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, c)).astype(
        np.float32)).to(cuda) for k, c in (("H1", 3), ("P1", 21), ("D1", 3),
                                           ("H2", 3), ("P2", 21), ("D2", 3))}
    step = make_train_step(system)
    for _ in range(2):
        step(batch, 2e-4)
    ckpt = CheckpointManager(str(tmp_path), "card")
    ckpt.save(system, "latest")
    with pytest.warns(UserWarning, match="RANDOM VGG19"):
        fresh = build_system(cfg, cuda)
    ckpt.restore(fresh, "latest")

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}.{k}")
        else:
            yield prefix, tree

    want, got = dict(flat(system.state_dict())), dict(flat(fresh.state_dict()))
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k].cpu(), v.cpu()), k
        else:
            assert got[k] == v, k
    assert fresh.pool_pb.images.is_cuda and fresh.step == 2
    assert all(torch.isfinite(torch.tensor(float(v)))
               for v in make_train_step(fresh)(batch, 2e-4).values())


@pytest.mark.cuda
def test_sync_bn_world_one_over_nccl_equals_plain(cuda):
    """Cross-rank BatchNorm in a NCCL group of one rank: the all-reduces of
    the moments and of their gradients change nothing, so output and input
    gradient equal the plain BatchNorm's bit for bit."""
    import torch.distributed as dist

    from mmhand_torch.models.layers import BatchNorm2d
    from mmhand_torch.parallel.dryrun import free_port

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        plain = BatchNorm2d(64).to(cuda)
        synced = BatchNorm2d(64, cross_rank=True).to(cuda)
        synced.load_state_dict(plain.state_dict())
        gen = torch.Generator(device=cuda).manual_seed(5)
        x = (torch.randn((4, 64, 32, 32), generator=gen, device=cuda)
             ).contiguous(memory_format=torch.channels_last)
        w = torch.randn(x.shape, generator=gen, device=cuda)
        outs = []
        for bn in (plain, synced):
            xr = x.clone().requires_grad_()
            y = bn(xr)
            (y * w).sum().backward()
            outs.append((y.detach(), xr.grad, bn.running_var.clone()))
        before = trace.counters().get("collectives.all_reduce_sum", 0)
        synced(x)
        assert trace.counters().get("collectives.all_reduce_sum", 0) == before + 1
    finally:
        dist.destroy_process_group()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _jointsmap_case(name, batch, height, width, seed=0):
    """Hand-sized poses, plus the edge cases of tests/test_torch_jointsmap.py:
    crossing bones (occlusion), equal depths (ties), zero-length bones and
    joints parked off the frame (and coincident there); then the cull's
    degenerate cases: bones of length 1e-7 and 5e-7, where (cos, sin) is not
    a unit vector (tiny), half_len at its 1e-3 floor (floor), NaN keypoints
    and depths (nan), long bones crossing the frame (long), and ellipses
    whose tips and sides touch the warp tiles' edges (graze)."""
    rng = np.random.RandomState(seed)
    scale = np.array([width, height], np.float32)
    uv = ((rng.uniform(0.3, 0.7, (batch, 1, 2))
           + rng.normal(0, 0.18, (batch, 21, 2))) * scale).astype(np.float32)
    z = (rng.uniform(300, 700, (batch, 21)) / 700 * 255).astype(np.float32)
    if name == "occlusion":
        uv[:] = -500.0
        z[:] = 1.0e6
        uv[:, 1], uv[:, 2] = [20, 128], [236, 128]
        uv[:, 5], uv[:, 6] = [128, 20], [128, 236]
        z[:, [1, 2]], z[:, [5, 6]] = 0.2, 0.8
    elif name == "tie":
        z[:] = 100.0
    elif name == "zero_length":
        uv[:, 2] = uv[:, 1]
        uv[:, 18] = uv[:, 19] = uv[:, 20] = uv[:, 17]
    elif name == "parked":
        uv[:, 5:] = [-1000.0, 4000.0]
    elif name == "tiny":            # bones 8 (1, 2) and 11 (5, 6)
        uv[:, 1], uv[:, 2] = [1e-7, 0.0], [0.0, 0.0]
        uv[:, 5], uv[:, 6] = [2e-7, 3e-7], [5e-7, -1e-7]
        z[:, [1, 2, 5, 6]] = 50.0
    elif name == "floor":           # bones 14 (9, 10) and 18 (14, 15)
        uv[:, 9] = [width / 2, height / 2]
        uv[:, 10] = uv[:, 9] + [1e-3, 0.0]
        uv[:, 14] = [width / 4 + 0.5, height / 4]
        uv[:, 15] = uv[:, 14] + [0.0, 2e-3]
        z[:, [9, 10, 14, 15]] = 10.0
    elif name == "nan":
        uv[:, 3] = np.nan
        uv[:, 7, 0] = np.nan
        z[:, 12] = np.nan
    elif name == "long":            # bones 5 (17, 18) and 17 (13, 14)
        uv[:, 17], uv[:, 18] = [-3000.0, 0.2 * height], [3000.0, 0.85 * height]
        uv[:, 13], uv[:, 14] = [0.5 * width, -4000.0], [0.4 * width, 4000.0]
        z[:, [13, 14, 17, 18]] = 20.0
    elif name == "graze":           # tiles of 16 x 8 pixels from (0, 0)
        uv[:, 1], uv[:, 2] = [16.0, 40.0], [32.0, 40.0]    # tip at col 32
        uv[:, 5], uv[:, 6] = [70.0, 24.0], [70.0, 48.0]    # tip at row 48
        uv[:, 9], uv[:, 10] = [100.0, 35.0], [120.0, 35.0]  # side on row 40
        uv[:, 13], uv[:, 14] = [44.0, 60.0], [60.0, 76.0]  # diagonal
        z[:, [1, 2, 5, 6, 9, 10, 13, 14]] = 30.0
    return torch.from_numpy(uv), torch.from_numpy(z)


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch,height,width", [
    ("poses", 16, 256, 256), ("poses", 8, 256, 256), ("poses", 3, 70, 90),
    ("occlusion", 2, 256, 256), ("tie", 2, 256, 256),
    ("zero_length", 2, 256, 256), ("parked", 2, 256, 256),
    ("tiny", 2, 256, 256), ("floor", 2, 256, 256), ("nan", 2, 256, 256),
    ("long", 2, 256, 256), ("graze", 2, 256, 256), ("graze", 3, 70, 90)])
def test_jointsmap_kernel_equals_cpu_plain(cuda, name, batch, height, width):
    """K3 against its plain version run on the CPU: bit for bit (one IEEE
    rounding per operation on both).  The plain version run on the card is
    not the yardstick: torch on CUDA divides by a Python scalar as a
    multiply by its reciprocal."""
    uv, z = _jointsmap_case(name, batch, height, width)
    before = launches("k3")
    got = generate_jointsmap(uv.to(cuda), z.to(cuda), height, width)
    torch.cuda.synchronize()
    assert launches("k3") == before + 1
    assert got.shape == (batch, height, width) and got.is_cuda
    assert torch.equal(got.cpu(), generate_jointsmap_ref(uv, z, height, width))


@pytest.mark.cuda
def test_jointsmap_kernel_checks_its_input(cuda):
    uv, z = torch.zeros(2, 21, 2, device=cuda), torch.zeros(2, 21, device=cuda)
    with pytest.raises(TypeError):
        generate_jointsmap(uv.double(), z.double())
    with pytest.raises(ValueError):
        generate_jointsmap(torch.zeros(2, 20, 2, device=cuda), z[:, :20])
    with pytest.raises(ValueError):
        generate_jointsmap(uv.transpose(0, 1), z.t())
    with pytest.raises(ValueError):
        generate_jointsmap(uv, z.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["synthetic", "rhd"])
def test_kernels_on_the_paths_keypoints_match_plain(cuda, source, tmp_path):
    """K1 and K3 on the keypoints the paths render, at their shapes: the
    synthetic set's first batch (generation and training at sigma 6; the
    baselines' jointsmaps at batch 8, depth / 700 * 255) and an RHD-layout
    tree's (the HPE step at sigma 5, batch 32; PATN2 scoring at sigma 6).
    K1 within 1e-6 of its plain version off the clip boundary and 0
    wherever it skipped; K3 bit for bit against its plain version on the
    CPU."""
    from mmhand_torch.data import HostLoader, build_dataset
    from mmhand_torch.data.rhd_tree import write_rhd_tree
    from mmhand_torch.hpe import HPEMixDataset

    if source == "synthetic":
        cfg = Config(model=ModelConfig(fine_size=256),
                     data=DataConfig(dataset="synthetic"), is_train=False)
        raw = next(iter(HostLoader(build_dataset(cfg), 16, shuffle=False,
                                   max_items=16).epoch(0)))
        heat = [(raw["src_uv"], 6.0), (raw["tgt_uv"], 6.0)]
        uv = torch.from_numpy(raw["tgt_uv"][:8])
        z = torch.from_numpy((np.asarray(raw["tgt_z"][:8]) / 700.0 * 255.0
                              ).astype(np.float32))
        got = generate_jointsmap(uv.to(cuda), z.to(cuda), 256, 256)
        assert torch.equal(got.cpu(), generate_jointsmap_ref(uv, z, 256, 256))
    else:
        tree = write_rhd_tree(tmp_path / "rhd", 32, 256, 0)
        cfg = Config(model=ModelConfig(fine_size=256),
                     data=DataConfig(dataset="RHD", dataroot=tree))
        uv = HPEMixDataset(cfg).batch(range(32))["uv"]
        heat = [(uv, 5.0), (uv, 6.0)]
    for uv, sigma in heat:
        uv = torch.from_numpy(np.asarray(uv, np.float32))
        got = gaussian_heatmaps(uv.to(cuda), 256, 256, sigma).cpu()
        want = gaussian_heatmaps_ref(uv, 256, 256, sigma)
        skipped = skipped_elements(uv, 256, 256, sigma)
        assert not bool(got[skipped].any())
        keep = _off_clip_boundary(uv.numpy(), 256, 256, sigma)
        assert keep.mean() > 1 - 1e-3
        np.testing.assert_allclose(np.where(keep, got.numpy(), 0),
                                   np.where(keep, want.numpy(), 0),
                                   rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_evaluator_on_card_matches_cpu(cuda):
    """The conditioning image exactly; Inception, SSIM, the judge's
    heatmaps (every stage, within 1e-4 of their largest value) and its z in
    float32 with TF32 off, to 1e-4 (conv taps summed in another order)."""
    from mmhand_torch.eval.evaluator import full_fp32

    uv, z = _jointsmap_case("poses", 2, 64, 64, seed=3)
    xyz = torch.cat([uv, z[..., None]], -1)
    cond = Evaluator.create_input_image(xyz.to(cuda), 64)
    assert torch.equal(cond.cpu(), Evaluator.create_input_image(xyz, 64))

    with pytest.warns(UserWarning, match="RANDOM"):
        on_cpu = Evaluator(judge=HPEJudge.random_init(size=64, device="cpu"),
                           device="cpu")
    with pytest.warns(UserWarning, match="RANDOM"):
        on_card = Evaluator(judge=HPEJudge.random_init(size=64, device=cuda),
                            device=cuda)
    rng = np.random.RandomState(4)
    gt = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    pred = (gt * 0.8).contiguous()
    for a, b in zip(on_card.inception_forward(pred.to(cuda)),
                    on_cpu.inception_forward(pred)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(
        on_card.ssim_forward(pred.to(cuda), gt.to(cuda)).cpu().numpy(),
        on_cpu.ssim_forward(pred, gt).numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(on_card.judge.predict(pred.to(cuda))[2].cpu().numpy(),
                               on_cpu.judge.predict(pred)[2].numpy(),
                               rtol=1e-4, atol=1e-4 * 64)
    with full_fp32():
        stages = zip(on_card.judge.hpm2d(pred.to(cuda)), on_cpu.judge.hpm2d(pred))
        for a, b in stages:
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                       atol=1e-4 * float(b.abs().max()))


def adam_step_bound(t: int, beta1: float, beta2: float) -> float:
    """The largest |m_hat / sqrt(v_hat)| Adam can take at step ``t`` (eps
    0), over every gradient sequence: by Cauchy-Schwarz,
    (1 - b1) / (1 - b1^t) * sqrt((1 - b2^t) / (1 - b2))
    * sqrt(sum_i b1^(2 (t - i)) / b2^(t - i)).  1 at t = 1; 1.0539 at t = 2
    for betas (0.5, 0.999)."""
    s = sum(beta1 ** (2 * (t - i)) / beta2 ** (t - i) for i in range(1, t + 1))
    return ((1 - beta1) / (1 - beta1 ** t)
            * ((1 - beta2 ** t) / (1 - beta2)) ** 0.5 * s ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["hpm", "hpm3d"])
def test_hpe_step_on_card_matches_cpu(cuda, variant, record_property):
    """Two HPE steps at 32 px from the same weights and batches, f32 with
    TF32 off, the sigma-5 heatmaps rendered by K1 on the card: K1 once per
    batch, losses within tests/test_torch_hpe.py's 2e-4.

    Each step on the CPU replays the card's ReLU and max-pool decisions
    (``kink_decisions``): where a ReLU input lies within rounding of 0 on
    one side, every gradient below it moves (on an H100 by up to 4.9e-2 of
    a norm, PYTHONHASHSEED 3), and both are valid subgradients.  So do two
    copies of the card's nets as the step starts, on the CPU in float32
    and float64: from the same weights, every Hpm2d and Hpm3d gradient of
    the card within 1e-4 of the float32 copy's (the norm of the difference
    against the leaf's norm), plus 4x that copy's own error against
    float64 (``gradients_off``).  (From the CPU's own weights after a first
    step, Hpm3d's gradients of 1e-7 in its last stage part by up to 1e-4
    of a norm on an H100, PYTHONHASHSEED 7: Adam's first step moved the
    two sides' weights apart by up to 3e-7.)  Every replayed decision that
    differs from a pass's own lies within ``KINK_MARGIN`` of the input's
    largest |x|.  After the two
    steps, at most 0.5% of each net's parameters more than 2e-5 + 1e-3 |w|
    apart (Adam moves a parameter whose gradient is at rounding level by
    a whole step, either way), and none beyond the most two Adam runs from
    one start can part, 2 lr (1 + 1.0539) at betas (0.5, 0.999)
    (``adam_step_bound``)."""
    from mmhand_torch.hpe import (
        HPEMixDataset,
        HPESystem,
        make_hpe_prepare_batch,
        make_hpe_train_step,
    )
    from mmhand_torch.models.check_nets import (
        KINK_MARGIN,
        gradients_off,
        kink_decisions,
    )

    lr, steps = 2e-4, 2
    cfg = Config(model=ModelConfig(fine_size=32),
                 data=DataConfig(dataset="synthetic"),
                 precision=PrecisionConfig(compute_dtype="float32"))
    on_cpu = HPESystem(cfg, variant, "cpu")
    on_card = HPESystem(cfg, variant, cuda)
    nets = [n for n in ("hpm2d", "hpm3d") if getattr(on_cpu, n) is not None]
    for n in nets:
        b = getattr(on_cpu, n).state_dict()
        for k, v in getattr(on_card, n).state_dict().items():
            assert torch.equal(v.cpu(), b[k]), f"{n}.{k} starts apart"
    dataset = HPEMixDataset(cfg, length_for_synthetic=8)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for i in range(steps):
            raw = dataset.batch(range(3 * i, 3 * i + 3))
            raw["weight"] = np.array([1, 1 - i, 1], np.int32)
            before = launches("k1")
            batch = make_hpe_prepare_batch(device=cuda)(raw)
            assert launches("k1") == before + 1
            # copies of the card's nets as the step starts, on the CPU in
            # float32 and in float64, for its gradients; their optimizer's
            # update is never read
            ref, exact = copy.deepcopy(on_cpu), copy.deepcopy(on_cpu)
            for name in nets:
                for system, dtype in ((ref, torch.float32),
                                      (exact, torch.float64)):
                    net = getattr(system, name)
                    net.load_state_dict(getattr(on_card, name).state_dict())
                    setattr(system, f"opt{name[3:]}", torch.optim.SGD(
                        net.to(dtype).parameters(), lr=0.0))
            cpu_batch = make_hpe_prepare_batch(device="cpu")(raw)
            decisions, margins = [], []
            with kink_decisions(record=decisions):
                got = make_hpe_train_step(on_card)(batch, lr)

            def replayed(system, b):
                replay = iter(decisions)
                with kink_decisions(replay=replay, margins=margins):
                    out = make_hpe_train_step(system)(b, lr)
                assert decisions and next(replay, None) is None
                return out

            want = replayed(on_cpu, cpu_batch)
            replayed(ref, cpu_batch)
            replayed(exact, {k: v.double() if v.is_floating_point() else v
                             for k, v in cpu_batch.items()})
            worst = max(margins, key=lambda m: m[2])
            record_property(f"step{i}_decided_apart", sum(m[1] for m in margins))
            record_property(f"step{i}_kink_margin", worst[2])
            assert worst[2] <= KINK_MARGIN, f"step {i}: {worst}"
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(float(got[k]), float(v), rtol=2e-4,
                                           err_msg=k)
            for name in nets:
                off, gap, e_cpu = gradients_off(
                    getattr(exact, name), getattr(ref, name),
                    getattr(on_card, name))
                record_property(f"step{i}_{name}_gradient_gap", gap)
                record_property(f"step{i}_{name}_cpu_gradient_error", e_cpu)
                assert not off, f"step {i} {name}: {off}"
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    f32_eps = torch.finfo(torch.float32).eps
    moved = 2 * lr * sum(adam_step_bound(t, cfg.optim.beta1, cfg.optim.beta2)
                         for t in range(1, steps + 1))
    for name in nets:
        a = getattr(on_card, name).state_dict()
        outside = total = 0
        largest = 0.0
        for k, v in getattr(on_cpu, name).state_dict().items():
            diff = (a[k].cpu() - v).abs()
            outside += int((diff > 2e-5 + 1e-3 * v.abs()).sum())
            total += v.numel()
            largest = max(largest, float(diff.max()))
            # and one rounding of each side's stored weight per step
            bound = moved + steps * f32_eps * (v.abs() + moved)
            assert bool((diff <= bound).all()), \
                f"{name}.{k}: {float(diff.max())} against {moved}"
        record_property(f"{name}_largest_parameter_gap", largest)
        record_property(f"{name}_share_outside", outside / total)
        assert outside <= 0.005 * total, f"{name}: {outside} of {total}"


def test_adam_step_bound_is_adams_largest_step():
    """The bound against Adam itself: a gradient sequence in the ratio that
    maximizes the second step (g2 = g1 * b2 / b1, Cauchy-Schwarz's
    equality) reaches it, and random sequences stay under it."""
    b1, b2 = 0.5, 0.999
    assert adam_step_bound(1, b1, b2) == pytest.approx(1.0)
    assert adam_step_bound(2, b1, b2) == pytest.approx(1.0539, abs=1e-4)
    steps = []
    for grads in ([1e-3, 1e-3 * b2 / b1], *np.random.RandomState(0).normal(
            0, 1, (20, 2)).tolist()):
        p = torch.zeros(1, dtype=torch.float64, requires_grad=True)
        opt = torch.optim.Adam([p], lr=1.0, betas=(b1, b2), eps=0.0)
        for t, g in enumerate(grads, 1):
            p.grad = torch.tensor([float(g)], dtype=torch.float64)
            before = float(p)
            opt.step()
            steps.append(abs(float(p) - before))
            assert steps[-1] <= adam_step_bound(t, b1, b2) * (1 + 1e-12)
    assert steps[1] == pytest.approx(adam_step_bound(2, b1, b2), rel=1e-12)


@pytest.mark.cuda
def test_pix2pixhd_labels_on_card_equal_plain(cuda, tmp_path):
    """``export_baseline_formats pix2pixhd`` rasterizes its labels with K3
    in batches: the label PNGs equal those of the plain version on the CPU
    byte for byte, one launch per batch."""
    import filecmp
    import os

    from mmhand_torch.data.preprocess import create_rhd_db
    from mmhand_torch.data.raw_sources import write_raw_rhd
    from mmhand_torch.scripts.export_baseline_formats import export_pix2pixhd

    raw = write_raw_rhd(tmp_path / "raw", 8, seed=2)
    crops = str(tmp_path / "crops")
    n = create_rhd_db(raw, crops, 256, workers=4)
    before = launches("k3")
    assert export_pix2pixhd(crops, str(tmp_path / "card"), 256, cuda, 4) == n
    assert launches("k3") == before + -(-n // 4)
    export_pix2pixhd(crops, str(tmp_path / "cpu"), 256, "cpu", 4)
    names = sorted(os.listdir(tmp_path / "cpu" / "train_label"))
    assert len(names) == n
    for name in names:
        assert filecmp.cmp(tmp_path / "card" / "train_label" / name,
                           tmp_path / "cpu" / "train_label" / name,
                           shallow=False), name


def _on_card(net, cuda):
    return copy.deepcopy(net).to(device=cuda, memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["patn2", "nlayer", "pixel", "generator",
                                  "pose_resnet50"])
def test_zoo_forward_on_card_matches_cpu(cuda, arch):
    """PATN2Stream, NLayerDiscriminator and PixelDiscriminator (full width),
    a toy MM-Hand generator (ngf 8, 2 blocks) and PoseResNet-50 in eval
    mode, float32 with TF32 off, to 1e-4 (conv taps summed in another
    order)."""
    from mmhand_torch.eval.evaluator import full_fp32
    from mmhand_torch.models.baselines import (
        NLayerDiscriminator,
        PATN2Stream,
        PixelDiscriminator,
    )
    from mmhand_torch.models.generator import Generator
    from mmhand_torch.models.layers import init_weights

    rng = np.random.RandomState(5)
    if arch == "pose_resnet50":
        net = make_test_pose_resnet(50).eval()
        x = torch.from_numpy(rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32))
    else:
        make = {"patn2": PATN2Stream, "nlayer": NLayerDiscriminator,
                "pixel": PixelDiscriminator,
                "generator": functools.partial(Generator, ngf=8,
                                               n_blocks=2)}[arch]
        gen = torch.Generator().manual_seed(1)
        net = init_weights(make(compute_dtype=None), "normal", gen).eval()
        with torch.no_grad():  # a real signal, tanh not saturated
            for m in net.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0, 0.05, generator=gen)
                    m.running_var.uniform_(0.1, 1.0, generator=gen)
        x = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
        if arch in ("patn2", "generator"):  # the poses; the generator's depths
            x = (x, torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 42)).astype(
                np.float32)))
        if arch == "generator":
            x += (torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 6)).astype(
                np.float32)),)
    card = _on_card(net, cuda)
    with full_fp32():
        want = net(x)
        got = card(tuple(a.to(cuda) for a in x) if isinstance(x, tuple)
                   else x.to(cuda))
    assert got.shape == want.shape
    if arch not in ("nlayer", "pixel"):
        assert got.std() > 1e-3
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
def test_pose_resnet_train_bn_on_card_equals_plain(cuda):
    """One train-mode forward and backward of PoseResNet-50 in float32 with
    TF32 off: K2 and K2b at its 56 BatchNorms; the output and the running
    statistics it leaves against the plain version on the CPU; the
    gradients against float64."""
    net = make_test_pose_resnet(50, seed=3).train()
    card = _on_card(net, cuda)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (2, 32, 32, 21)).astype(np.float32))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = (launches("k2"), launches("k2b"))
        got = card(x.to(cuda))
        (got * w.to(cuda)).sum().backward()
        torch.cuda.synchronize()
        assert (launches("k2") - before[0],
                launches("k2b") - before[1]) == (56, 56)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    want = net(x)
    (want * w).sum().backward()
    np.testing.assert_allclose(got.detach().cpu().numpy(),
                               want.detach().numpy(), rtol=1e-4, atol=1e-4)
    a, b = card.state_dict(), net.state_dict()
    for k, v in b.items():
        if "running" in k:
            np.testing.assert_allclose(a[k].cpu().numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    # the gradients against float64 (torch's functional BatchNorm): the
    # card's f32 within 4x the CPU's f32, as a share of each tensor's norm;
    # at batch 2 the f32 gradients of this random net lie up to ~15% from
    # float64 in layer4 on the CPU alone
    f64 = copy.deepcopy(net).double()
    (pose_resnet_f64(f64, x.double()) * w.double()).sum().backward()
    for (k, p), q, r in zip(net.named_parameters(), card.parameters(),
                            f64.parameters()):
        scale = float(r.grad.norm())
        e_cpu = float((p.grad.double() - r.grad).norm()) / scale
        e_card = float((q.grad.cpu().double() - r.grad).norm()) / scale
        assert e_card <= 4 * e_cpu + 1e-6, (k, e_card, e_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 1, 17, 20, 24), (2, 21, 17, 20, 24), (2, 16, 17, 20, 24),
    (3, 1, 5, 7, 9), (3, 2, 5, 7, 9), (3, 3, 5, 7, 9), (3, 5, 5, 7, 9),
    (3, 21, 5, 7, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_kernels_on_5d_input_match_plain(cuda, shape, dtype):
    """K2 and K2b on a 5-D ``channels_last_3d`` tensor, the voxel nets'
    layout, at widths that are no multiple of the vector width (C 1, 2, 3,
    5 and 21; at N = 3 * 5 * 7 * 9 = 945, N mod k != 0) and a vector one
    (16), held as ``test_bn_kernels_match_plain`` holds them; a 5-D tensor
    in another layout raises."""
    channels = shape[1]
    x, gen = _bn_input(shape, dtype, 0, channels, cuda)
    g1 = torch.randn(channels, generator=gen, device=cuda)
    g2 = torch.randn(channels, generator=gen, device=cuda)
    before = (launches("k2"), launches("k2b"))
    _hold_bn_kernels(x, g1, g2)
    assert (launches("k2"), launches("k2b")) == (
        before[0] + 1, before[1] + 1)
    if channels > 1:
        with pytest.raises(ValueError, match="channels_last"):
            bn_sums(x.contiguous())


def _voxel_case(name, rng):
    """A port voxel or depth net with random weights and BatchNorm
    statistics, its input at a small size, and its layout."""
    from mmhand_torch.models import voxel_nets
    from mmhand_torch.models.layers import init_lecun_normal

    make, shape, layout = {
        "VoxelGenerator": (voxel_nets.VoxelGenerator, (2, 16, 16, 16, 1),
                           torch.channels_last_3d),
        "VoxelDiscriminator": (voxel_nets.VoxelDiscriminator,
                               (2, 64, 64, 64, 2), torch.channels_last_3d),
        "DepthGenerator": (voxel_nets.DepthGenerator, (4, 42),
                           torch.channels_last),
        "DepthDiscriminator": (functools.partial(
            voxel_nets.DepthDiscriminator, ndf=8), (2, 256, 256, 1),
            torch.channels_last)}[name]
    gen = torch.Generator().manual_seed(len(name))
    net = init_lecun_normal(make(), gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.normal_(1.0, 0.1, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
    x = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    return net.train(), x, layout


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["VoxelGenerator", "VoxelDiscriminator",
                                  "DepthGenerator", "DepthDiscriminator"])
def test_voxel_nets_train_pass_on_card_matches_cpu(cuda, name,
                                                   record_property):
    """One train-mode forward and backward of each depth and voxel net in
    float32 with TF32 off: K2 and K2b at every BatchNorm; outputs within
    1e-4 of their largest value and the running statistics within 1e-5 of
    the CPU's.  The CPU's float32 and float64 passes replay the card's
    (Leaky)ReLU and max-pool decisions (``kink_decisions``; each that
    differs from a pass's own within ``KINK_MARGIN`` of the input's largest
    |x|).  Every gradient of the card within 1e-4 of its norm of the
    CPU's float32 one, plus 4x the CPU's own error against float64
    (``gradients_off``), but those of the conv biases before a BatchNorm,
    0 in exact arithmetic.
    The discriminator runs at 64^3, where its last BatchNorm sees 27 values
    per sample (1 at 16^3)."""
    from mmhand_torch.models.check_nets import (
        KINK_MARGIN,
        biases_before_batchnorm,
        gradients_off,
        kink_decisions,
    )

    net, x, layout = _voxel_case(name, np.random.RandomState(7))
    card = copy.deepcopy(net).to(device=cuda, memory_format=layout)
    f64 = copy.deepcopy(net).double()
    n_bn = sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
               for m in net.modules())

    def loss(outs):
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum((o * torch.linspace(-1, 1, o.numel(), device=o.device,
                                       dtype=o.dtype).view(o.shape)
                    ).sum() for o in outs), outs

    before = (launches("k2"), launches("k2b"))
    decisions = []
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with kink_decisions(record=decisions):
            got_loss, got = loss(card(x.to(cuda)))
        got_loss.backward()
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert (launches("k2") - before[0],
            launches("k2b") - before[1]) == (n_bn, n_bn)
    margins = []

    def replayed(model, inp):
        replay = iter(decisions)
        with kink_decisions(replay=replay, margins=margins):
            total, outs = loss(model(inp))
        total.backward()
        assert decisions and next(replay, None) is None
        return outs

    want = replayed(net, x)
    replayed(f64, x.double())
    worst = max(margins, key=lambda m: m[2])
    record_property("decided_apart", sum(m[1] for m in margins))
    record_property("kink_margin", worst[2])
    assert worst[2] <= KINK_MARGIN, worst
    for g, w in zip(got, want):
        scale = float(w.detach().abs().max())
        np.testing.assert_allclose(g.detach().cpu().numpy(),
                                   w.detach().numpy(), rtol=0,
                                   atol=1e-4 * scale)
    off, gap, e_cpu = gradients_off(f64, net, card)
    record_property("gradient_gap", gap)
    record_property("cpu_gradient_error", e_cpu)
    assert not off, off
    assert len(biases_before_batchnorm(net)) == {"VoxelGenerator": 31,
                                                 "DepthGenerator": 5}.get(
        name, 0)
    a = card.state_dict()
    for k, v in net.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(a[k].cpu().numpy(), v.numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)


@pytest.mark.cuda
def test_v2v_voxelization_on_card_matches_cpu(cuda):
    """Four augmented samples through V2VVoxelization on the card and on the
    CPU with the same RandomState draws: the keypoint coordinates within
    1e-4 voxel; the cubes equal but for voxels on a threshold, classified
    in float64: an input voxel differs only where a point lies within 1e-4
    of a voxel edge (``edge_voxels``), a hand voxel only there or where a
    bone's quadric lies within 1e-5 of 1 (``bone_boundary``)."""
    from mmhand_torch.models.check_nets import bone_boundary, edge_voxels
    from mmhand_torch.ops.voxelize import V2VVoxelization, generate_coord

    rng = np.random.RandomState(3)
    on_card = V2VVoxelization(200.0, True, np.random.RandomState(0), cuda)
    on_cpu = V2VVoxelization(200.0, True, np.random.RandomState(0), "cpu")
    size = on_cpu.sizes[1]
    for _ in range(4):
        ref = np.array([0.0, 0.0, 350.0], np.float32)
        sample = {"points": (rng.uniform(-90, 90, (4096, 3)) + ref).astype(
                      np.float32),
                  "keypoints": (rng.uniform(-70, 70, (21, 3)) + ref).astype(
                      np.float32),
                  "refpoint": ref}
        peek = np.random.RandomState()
        peek.set_state(on_cpu.rng.get_state())
        draws = V2VVoxelization(200.0, True, peek, "cpu")._draws()
        got = on_card(sample)
        want = on_cpu(sample)
        assert all(g.device.type == "cuda" for g in got)
        np.testing.assert_allclose(got[1].cpu().numpy(), want[1].numpy(),
                                   rtol=0, atol=1e-4)
        point_coord = generate_coord(torch.from_numpy(sample["points"]),
                                     sample["refpoint"], *draws,
                                     on_cpu.sizes).numpy()
        differ = (got[0].cpu() != want[0])[0].numpy()
        assert not (differ & ~edge_voxels(point_coord, size, 1e-4)).any()
        hand_differ = (got[2].cpu() != want[2])[0].numpy()
        boundary = (bone_boundary(want[1].numpy(), size, 1e-5)
                    | edge_voxels(want[1].numpy(), size, 1e-4))
        assert not (hand_differ & ~boundary).any()
        assert float(want[2].sum()) > 21


# each net as its path runs it: (its train-mode BatchNorm calls, batch,
# input shapes); PoseResNet-50 and the 2D baselines in bf16, the voxel and
# depth nets in f32
NET_BN_CASES = {
    "PoseResNet-50": (56, [(32, 256, 256, 3)]),
    "NLayerDiscriminator": (3, [(8, 256, 256, 3)]),
    "PixelDiscriminator": (1, [(8, 256, 256, 3)]),
    "PATN2Stream": (35, [(8, 256, 256, 3), (8, 256, 256, 42)]),
    "VoxelGenerator": (31, [(8, 64, 64, 64, 1)]),
    "VoxelDiscriminator": (4, [(8, 64, 64, 64, 2)]),
    "DepthGenerator": (5, [(32, 42)]),
    "DepthDiscriminator": (3, [(8, 256, 256, 1)])}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(NET_BN_CASES))
def test_bn_kernels_on_net_inputs_match_plain(cuda, name):
    """K2 and K2b on every train-mode BatchNorm input of a net at the width,
    batch and type its path runs it (``_hold_bn_kernels``): real
    activations, in the layouts and at the strides the nets give them."""
    from mmhand_torch.models import baselines, voxel_nets
    from mmhand_torch.models.layers import init_lecun_normal, init_weights

    sites, shapes = NET_BN_CASES[name]
    gen = torch.Generator().manual_seed(0)
    if name == "PoseResNet-50":
        net = make_test_pose_resnet(50, torch.bfloat16)
    elif hasattr(baselines, name):
        net = init_weights(getattr(baselines, name)(compute_dtype=None),
                           "normal", gen)
        net.compute_dtype = torch.bfloat16
    else:
        net = init_lecun_normal(getattr(voxel_nets, name)(), gen)
    layout = torch.channels_last_3d if name.startswith("Voxel") else (
        torch.channels_last)
    net = net.to(device=cuda, memory_format=layout).train()
    on_card = torch.Generator(device=cuda).manual_seed(1)
    x = [torch.rand(shape, generator=on_card, device=cuda) * 2 - 1
         for shape in shapes]
    inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[0].detach()))
        for m in net.modules() if isinstance(m, (BatchNorm2d, BatchNorm3d))]
    try:
        with torch.no_grad():
            net(tuple(x) if len(x) > 1 else x[0])
    finally:
        for h in hooks:
            h.remove()
    assert len(inputs) == sites
    for t in inputs:
        c = t.shape[1]
        _hold_bn_kernels(t, torch.randn(c, generator=on_card, device=cuda),
                         torch.randn(c, generator=on_card, device=cuda))


@pytest.mark.cuda
def test_pose_search_on_card_matches_cpu(cuda):
    """knn_pose_distance (k 25) over 76,375 random poses, MSRA15's count, in
    float64: the card's indices are the CPU's, its distances within
    1e-12."""
    from mmhand_torch.eval.pose_search import knn_pose_distance

    rng = np.random.RandomState(0)
    database = rng.normal(0, 40, (76375, 21, 3))
    query = rng.normal(0, 40, (21, 3))
    idx, dist = knn_pose_distance(query, database, 25, device=cuda)
    want_idx, want_dist = knn_pose_distance(query, database, 25, device="cpu")
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(dist, want_dist, rtol=0, atol=1e-12)


def _hand3d_records(n: int, size: int, seed: int) -> dict:
    """Raw hand3d records at ``size`` px: left- or right-hand pixels in each
    mask, most keypoints visible."""
    rng = np.random.RandomState(seed)
    parts = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        y, x = rng.randint(0, size // 2, 2)
        parts[i, y:y + size // 3, x:x + size // 3] = 5 if i % 2 else 20
    return {"keypoint_xyz": rng.normal(size=(n, 42, 3)).astype(np.float32),
            "keypoint_uv": rng.uniform(size * 0.1, size * 0.9,
                                       (n, 42, 2)).astype(np.float32),
            "cam_mat": np.tile(np.eye(3, dtype=np.float32) * size, (n, 1, 1)),
            "image": rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8),
            "hand_parts": parts, "keypoint_vis": rng.rand(n, 42) > 0.2}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["HandSegNet", "PoseNet2D", "PosePrior",
                                  "ViewpointNet", "PosePriorNetwork",
                                  "ColorHandPose3D"])
def test_hand3d_nets_on_card_match_cpu(cuda, name):
    """The hand3d nets and the whole ColorHandPose3D at 64 px in eval mode,
    float32 with TF32 off: every output within 1e-4 of its largest value
    (conv taps summed in another order); the pipeline's crop scale and
    centre equal."""
    from mmhand_torch.eval.evaluator import full_fp32
    from mmhand_torch.models import hand3d

    rng = np.random.RandomState(0)
    image = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 64, 64, 3))
                             .astype(np.float32))
    maps = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 21))
                            .astype(np.float32))
    side = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    make, args = {
        "HandSegNet": (hand3d.HandSegNet, (image,)),
        "PoseNet2D": (hand3d.PoseNet2D, (image,)),
        "PosePrior": (functools.partial(hand3d.PosePrior, in_size=8),
                      (maps[:, :8, :8], side)),
        "ViewpointNet": (functools.partial(hand3d.ViewpointNet, in_size=8),
                         (maps[:, :8, :8], side)),
        "PosePriorNetwork": (functools.partial(hand3d.PosePriorNetwork,
                                               crop_size=64), (maps, side)),
        "ColorHandPose3D": (functools.partial(hand3d.ColorHandPose3D,
                                              crop_size=64), (image, side)),
    }[name]
    net = hand3d.init_hand3d(make(), torch.Generator().manual_seed(0)).eval()
    if name == "ColorHandPose3D":
        with torch.no_grad():
            # a decisive segmentation head, so the mask and its box do not
            # hang on logits within rounding of each other
            net.HandSegNet.conv6_2.conv.weight.mul_(1e4)
    card = copy.deepcopy(net).to(cuda)
    with full_fp32():
        want = net(*args)
        got = card(*(a.to(cuda) for a in args))
    pairs = (list(zip(got, want)) if isinstance(want, (list, tuple))
             else [(got, want)])
    assert pairs
    for i, (g, w) in enumerate(pairs):
        if w is None:
            continue
        if name == "ColorHandPose3D" and i in (2, 3):  # scale, centre
            assert torch.equal(g.cpu(), w), i
        else:
            rel = float((g.cpu() - w).abs().max() / (w.abs().max() + 1e-30))
            assert rel <= 1e-4, (i, rel)


@pytest.mark.cuda
def test_hand3d_image_ops_and_derive_batch_on_card_match_cpu(cuda):
    """single_obj_scoremap bit for bit; crop_and_resize within 1e-4 (the
    card divides by a Python scalar as a multiply by its reciprocal: sample
    positions a few ulps apart); derive_batch (hand crop) within 1e-5 +
    1e-5 |x|, its hand side, masks and visibility equal."""
    from mmhand_torch.eval.evaluator import full_fp32
    from mmhand_torch.hand3d import PipelineConfig, derive_batch
    from mmhand_torch.ops import hand3d_image

    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.normal(size=(2, 64, 64, 2)).astype(np.float32))
    logits[:, 10:30, 20:40, 1] += 6.0
    image = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 64, 64, 3))
                             .astype(np.float32))
    boxes = torch.tensor([[0.1, -0.2, 0.7, 0.9], [-0.3, 0.2, 0.8, 1.4]])
    with full_fp32():
        mask = hand3d_image.single_obj_scoremap(logits)
        assert 0 < float(mask.sum()) < mask.numel()
        assert torch.equal(
            hand3d_image.single_obj_scoremap(logits.to(cuda)).cpu(), mask)
        want = hand3d_image.crop_and_resize(image, boxes, 48)
        got = hand3d_image.crop_and_resize(image.to(cuda), boxes.to(cuda), 48)
        assert float((got.cpu() - want).abs().max()) <= 1e-4
    raw = _hand3d_records(4, 64, 0)
    cfg = PipelineConfig(image_size=(64, 64), crop_size=32,
                         use_wrist_coord=False, hand_crop=True)
    want = derive_batch(raw, cfg, torch.Generator(), "cpu")
    got = derive_batch(raw, cfg, torch.Generator(device=cuda), cuda)
    for k, w in want.items():
        g = got[k].cpu()
        if w.dtype in (torch.bool, torch.int32):
            assert torch.equal(g, w), k
        else:
            assert float(((g - w).abs() - 1e-5 - 1e-5 * w.abs()).max()) <= 0, k
