"""The train-mode BatchNorm normalize (``ops.bn_stats.bn_apply``) on the CPU:
its plain forward against the op sequence it replaced, its analytic
backward against finite differences and against autograd of that sequence,
the BatchNorm layers through it, and its kernels' walk of K2's plan."""

import copy

import pytest
import torch

from mmhand_torch.models import layers as tl
from mmhand_torch.ops import bn_stats as tbn
from mmhand_torch.utils import trace
from test_torch_threads import two_threads  # noqa: F401

EPS = 1e-5


def todays_normalize(x, mean, mean_sq, weight, bias, eps=EPS):
    """The train-mode normalize as ``_FlaxBatchNorm.forward`` wrote it
    before ``bn_apply``: torch ops that autograd differentiates."""
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    shape = (-1,) + (1,) * (x.dim() - 2)
    scale = torch.rsqrt(var + eps) * weight
    y = (x.to(mean.dtype) - mean.view(shape)) * scale.view(shape)
    return (y + bias.view(shape)).to(x.dtype)


def _inputs(shape, dtype, seed, variances=None):
    """x, per-channel mean and mean of squares (mean^2 + ``variances``, so a
    negative entry gives a negative E[x^2] - E[x]^2), weight and bias."""
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=gen, dtype=dtype) * 1.5 + 0.3
    mean = 0.3 * torch.randn(c, generator=gen, dtype=dtype)
    if variances is None:
        variances = 0.5 + torch.rand(c, generator=gen, dtype=dtype)
    mean_sq = mean * mean + torch.as_tensor(variances, dtype=dtype)
    weight = 1 + 0.1 * torch.randn(c, generator=gen, dtype=dtype)
    bias = 0.1 * torch.randn(c, generator=gen, dtype=dtype)
    return x, mean, mean_sq, weight, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(3, 5, 4, 6), (2, 3, 4, 5, 6)])
def test_plain_forward_equals_todays_formula(shape, dtype):
    """The same operations in the same order: equal bit for bit."""
    args = _inputs(shape, dtype, 1)
    got = tbn.bn_apply(*args, EPS)
    assert got.dtype == dtype
    assert torch.equal(got, todays_normalize(*args))


@pytest.mark.parametrize("shape", [(2, 4, 3, 3), (2, 4, 2, 3, 2)])
def test_gradcheck_in_float64(shape):
    """The analytic backward against finite differences with respect to x,
    mean, mean_sq, weight and bias; channel 2's E[x^2] - E[x]^2 is
    negative, where the clamp stops the gradient of mean_sq."""
    args = [t.requires_grad_() for t in _inputs(
        shape, torch.float64, 2, [0.5, 1.0, -0.4, 0.2])]
    assert torch.autograd.gradcheck(
        lambda *a: tbn.bn_apply(*a, EPS), tuple(args))
    dy = torch.randn(shape, dtype=torch.float64)
    grads = torch.autograd.grad(tbn.bn_apply(*args, EPS), args[1:3], dy)
    assert float(grads[1][2]) == 0.0 and float(grads[1][0]) != 0.0


@pytest.mark.parametrize("shape", [(2, 3, 3, 3), (2, 3, 2, 3, 2)])
def test_zero_variance_passes_the_clamp(shape):
    """Where E[x^2] - E[x]^2 is exactly 0, torch's clamp passes the
    gradient (its mask is >= 0): the analytic gradients equal autograd of
    today's op sequence, and d mean_sq equals the one-sided difference from
    above, where the clamp is the identity."""
    x, mean, mean_sq, weight, bias = _inputs(shape, torch.float64, 3,
                                             [0.7, 0.0, 0.3])
    assert float(mean_sq[1] - mean[1] * mean[1]) == 0.0
    dy = torch.randn(shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(4))
    leaves = [t.clone().requires_grad_() for t in (x, mean, mean_sq, weight,
                                                   bias)]
    got = torch.autograd.grad(tbn.bn_apply(*leaves, EPS), leaves, dy)
    want = torch.autograd.grad(todays_normalize(*leaves), leaves, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    h = 1e-10  # far inside eps, where r^3 bends the slope
    up = mean_sq.clone()
    up[1] += h
    slope = float(((todays_normalize(x, mean, up, weight, bias)
                    - todays_normalize(x, mean, mean_sq, weight, bias))
                   * dy).sum()) / h
    assert got[2][1].item() == pytest.approx(slope, rel=1e-3)
    assert got[2][1].item() != 0.0


def _layer(cls, channels, seed, dtype):
    layer = cls(channels).to(dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        layer.weight.copy_(1 + 0.1 * torch.randn(channels, generator=gen))
        layer.bias.copy_(0.1 * torch.randn(channels, generator=gen))
    return layer.train()


class _TodaysBatchNorm:
    """The train-mode forward of ``_FlaxBatchNorm`` before ``bn_apply``, for
    a copy of a layer: the moments, the running statistics, then
    ``todays_normalize``."""

    def __init__(self, layer):
        self.layer = layer

    def __call__(self, x):
        m = self.layer
        mean, mean_sq = tbn.bn_moments(x)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            m.running_mean.lerp_(mean, m.momentum)
            m.running_var.lerp_(var, m.momentum)
            m.num_batches_tracked += 1
        return todays_normalize(x, mean, mean_sq, m.weight, m.bias, m.eps)


@pytest.mark.parametrize("cls,shape,layout", [
    (tl.BatchNorm2d, (4, 6, 5, 7), torch.contiguous_format),
    (tl.BatchNorm2d, (4, 6, 5, 7), torch.channels_last),
    (tl.BatchNorm3d, (2, 5, 4, 3, 6), torch.contiguous_format),
    (tl.BatchNorm3d, (2, 5, 4, 3, 6), torch.channels_last_3d)])
def test_batch_norm_train_pass_matches_todays_ops(cls, shape, layout):
    """A train-mode forward and backward of the port's BatchNorm layers in
    f32 against today's op sequence: output equal, running statistics
    equal, gradients of x, weight and bias within f32 rounding (the
    analytic backward adds in another order than autograd)."""
    layer = _layer(cls, shape[1], 5, torch.float32)
    old = copy.deepcopy(layer)
    gen = torch.Generator().manual_seed(6)
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).contiguous(
        memory_format=layout)
    dy = torch.randn(shape, generator=gen)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya = layer(xa)
    yb = _TodaysBatchNorm(old)(xb)
    assert torch.equal(ya, yb)
    ya.backward(dy)
    yb.backward(dy)
    for a, b in ((xa.grad, xb.grad), (layer.weight.grad, old.weight.grad),
                 (layer.bias.grad, old.bias.grad)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(
            b.abs().max()))
    for k in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(layer, k), getattr(old, k)), k


def test_frozen_and_eval_batch_norm_through_bn_apply():
    """Inside ``frozen_running_stats`` the normalize still runs and the
    running statistics stay; eval mode is torch's BatchNorm over them."""
    layer = _layer(tl.BatchNorm2d, 3, 7, torch.float32)
    x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(8))
    want = todays_normalize(x, *tbn.bn_moments(x), layer.weight, layer.bias)
    before = layer.running_var.clone()
    with tl.frozen_running_stats(layer):
        assert torch.equal(layer(x), want)
    assert torch.equal(layer.running_var, before)
    layer.eval()
    stock = torch.nn.functional.batch_norm(
        x, layer.running_mean, layer.running_var, layer.weight, layer.bias,
        False, 0.0, layer.eps)
    assert torch.equal(layer(x), stock)


def _backward_sums_by_plan(x, dy, mean, plan):
    """Per channel (sum dy, sum dy (x - mean)) as bn_apply_backward_kernel
    forms them under ``plan`` (K2's, with no head), by its index
    arithmetic (csrc/bn_stats.cu): thread (tile, lane) holds vector v =
    tile * lanes + lane of its chunk's super-rows, its slots' channels
    (v * vec + j) mod C; each tile's chunk partials sum into its slots;
    channel ch sums slots ch + i C at (s & ~(tw - 1)) * 2 + (s & (tw - 1)),
    then its tail elements.  Also returns how often each element of the
    body was read."""
    c, tw = plan.c, plan.slots
    vec = plan.width // plan.vectors
    flat_x = x.movedim(1, -1).reshape(-1)
    flat_g = dy.movedim(1, -1).reshape(-1)
    tail = plan.super_rows * plan.width
    reads = torch.zeros(plan.n_elems, dtype=torch.int64)
    slots = torch.zeros(plan.tiles, 2, tw, dtype=x.dtype)
    for v in range(plan.vectors):
        tile, lane = divmod(v, plan.lanes)
        ch = (v * vec + torch.arange(vec)) % c
        for chunk in range(plan.chunks):
            begin = chunk * plan.rows_per_chunk
            rows = torch.arange(begin, min(begin + plan.rows_per_chunk,
                                           plan.super_rows))
            at = (rows[:, None] * plan.vectors + v) * vec + torch.arange(vec)
            reads[at.reshape(-1)] += 1
            g = flat_g[at]
            part = slots[tile, :, lane * vec:(lane + 1) * vec]
            part[0] += g.sum(0)
            part[1] += (g * (flat_x[at] - mean[ch])).sum(0)
    s = torch.arange(c)[:, None] + torch.arange(plan.width // c) * c
    at = (s & ~(tw - 1)) * 2 + (s & (tw - 1))
    flat = slots.reshape(-1)
    a, b = flat[at].sum(1), flat[at + tw].sum(1)
    e = torch.arange(tail, plan.n_elems)
    g = flat_g[e]
    a = a.index_add(0, e % c, g)
    b = b.index_add(0, e % c, g * (flat_x[e] - mean[e % c]))
    return a, b, reads[:tail]


@pytest.mark.parametrize("c,elem_bytes", [
    (1, 4), (1, 2), (3, 2), (21, 2), (21, 4), (64, 2), (64, 4), (128, 2),
    (256, 2), (512, 2), (512, 4)])
def test_apply_walk_covers_every_element_once(c, elem_bytes):
    """The normalize's kernels walk K2's plan with no head: the body's
    16-byte vectors read every element before the tail once, and the
    backward's slots fold, with the tail, into each channel's sum dy and
    sum dy (x - mean)."""
    gen = torch.Generator().manual_seed(c)
    for n in (1, 63, 1000):
        plan = tbn.sums_plan(n, c, elem_bytes, 0, 132)
        x = torch.randn(n, c, 1, 1, generator=gen, dtype=torch.float64)
        dy = torch.randn(n, c, 1, 1, generator=gen, dtype=torch.float64)
        mean = x.mean((0, 2, 3))
        a, b, reads = _backward_sums_by_plan(x, dy, mean, plan)
        assert bool((reads == 1).all())
        assert plan.n_elems - plan.super_rows * plan.width < plan.width
        torch.testing.assert_close(a, dy.sum((0, 2, 3)), rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(
            b, (dy * (x - mean.view(1, -1, 1, 1))).sum((0, 2, 3)),
            rtol=1e-12, atol=1e-12)


def test_cpu_path_launches_no_kernel():
    """On the CPU the plain versions run: the kernels' counters stay 0."""
    trace.reset()
    try:
        layer = _layer(tl.BatchNorm2d, 4, 9, torch.float32)
        x = torch.randn(2, 4, 3, 3, requires_grad=True)
        layer(x).sum().backward()
        counted = trace.counters()
        assert all(counted.get(k, 0) == 0 for k in (
            "bn_apply.launches", "bn_apply_bwd.launches", "k2.launches",
            "k2b.launches"))
    finally:
        trace.reset()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks the CUDA wrappers make before a launch: the layout, the
    dtype, and per-channel vectors of C entries; a view off a 16-byte
    boundary is copied, in its layout, and an aligned tensor is not."""
    x = torch.zeros(2, 8, 4, 4)
    with pytest.raises(ValueError, match="bn_apply: .*channels_last"):
        tbn.rows_view(x, "bn_apply")
    with pytest.raises(ValueError, match=r"\(8,\)"):
        tbn._channel_f32(8, torch.zeros(8), torch.zeros(7))
    assert [t.dtype for t in tbn._channel_f32(
        3, torch.zeros(3, dtype=torch.float64))] == [torch.float32]
    view = torch.randn(1 + 2 * 8 * 4 * 4)[1:].view(2, 4, 4, 8).movedim(-1, 1)
    copied = tbn._aligned(view)
    assert view.data_ptr() % 16 and copied.data_ptr() % 16 == 0
    assert copied.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(copied, view)
    assert tbn._aligned(copied) is copied
