"""The reflect pad before each VALID conv (``ops.reflect_pad``,
``models.layers.ReflectPad2d``) on the CPU: the plain path against
``F.pad``, the backward kernel's gather mirrored in plain PyTorch
(``backward_by_gather``, which the card tests also hold the kernel to)
against autograd, the routing by device, the autograd wiring of the
kernels' path with the mirror standing in for them, and the nets with the
new module against ``nn.ReflectionPad2d``."""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from mmhand_torch.models import layers as tl
from mmhand_torch.models.baselines import ResnetGenerator
from mmhand_torch.models.discriminator import Discriminator
from mmhand_torch.models.generator import Generator
from mmhand_torch.ops import reflect_pad as rp
from mmhand_torch.utils import trace
from test_torch_threads import two_threads  # noqa: F401

# the widths of the GAN's pad sites (its f32 stems' 3, 6 and 24 channels,
# a ragged 51, its blocks' 256) at sizes from the least reflect allows
PAD_CASES = [(p, dtype, c, size)
             for p in (1, 3)
             for dtype in (torch.float32, torch.bfloat16)
             for c in (3, 6, 24, 51, 256)
             for size in (p + 1, 8, 17)]


def gather_sources(n: int, p: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Along an axis of ``n``, the padded indices whose gradient the
    backward kernel sums into each index i, in its order: (3, n) indices
    and a (3, n) mask of those that exist.  Row 0 is i + p itself, row 1
    p - i where 1 <= i <= p (the mirror at the start), row 2 2 (n - 1) - i
    + p where n - 1 - p <= i <= n - 2 (the mirror at the end)."""
    i = torch.arange(n)
    start = (i >= 1) & (i <= p)
    end = (i >= n - 1 - p) & (i <= n - 2)
    index = torch.stack([i + p, torch.where(start, p - i, 0),
                         torch.where(end, 2 * (n - 1) - i + p, 0)])
    return index, torch.stack([torch.ones(n, dtype=torch.bool), start, end])


def backward_by_gather(dy: torch.Tensor, p: int) -> torch.Tensor:
    """The input's gradient from ``dy``, the padded output's, as
    reflect_pad_backward_kernel forms it: for each input position, f32 sums
    over ``gather_sources`` of the rows (outer) and the columns (inner) in
    their order, from 0, rounded once to dy's type."""
    h, w = dy.shape[-2] - 2 * p, dy.shape[-1] - 2 * p
    rows, row_ok = gather_sources(h, p)
    cols, col_ok = gather_sources(w, p)
    g = dy.float()
    out = torch.zeros(dy.shape[:-2] + (h, w), dtype=torch.float32,
                      device=dy.device)
    for r in range(3):
        for c in range(3):
            ok = (row_ok[r][:, None] & col_ok[c][None, :]).to(dy.device)
            picked = g[..., rows[r].to(dy.device), :][..., cols[c].to(
                dy.device)]
            out += torch.where(ok, picked, 0.0)
    return out.to(dy.dtype)


def _input(c, size, dtype, seed, integers=False):
    """(2, c, size, size) in channels_last; small integers where the sums
    must be exact in any order."""
    gen = torch.Generator().manual_seed(seed)
    shape = (2, size, size, c)
    x = (torch.randint(-8, 9, shape, generator=gen).float() if integers
         else torch.randn(shape, generator=gen))
    return x.to(dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("p,dtype,c,size", PAD_CASES)
def test_plain_path_equals_f_pad(p, dtype, c, size):
    """On the CPU ``reflect_pad`` is ATen's pad: forward and autograd's
    backward equal ``F.pad(mode="reflect")``'s bit for bit."""
    x = _input(c, size, dtype, 1)
    dy = _input(c, size + 2 * p, dtype, 2)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    y = rp.reflect_pad(a, p)
    want = F.pad(b, (p,) * 4, mode="reflect")
    assert y.dtype == dtype and torch.equal(y, want)
    y.backward(dy)
    want.backward(dy)
    assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("p,dtype,c,size", PAD_CASES)
def test_gather_mirror_equals_autograd(p, dtype, c, size):
    """The backward kernel's index map, mirrored: every padded position is
    summed into exactly one input position, 1, 2 or 4 of them where 2p < n
    (up to 9 where the two mirrors overlap), and on integer gradients,
    whose sums are exact in any order and type, the mirror equals autograd
    of ``F.pad`` bit for bit."""
    counts = [gather_sources(size, p)[1].sum(0) for _ in range(2)]
    per_position = counts[0][:, None] * counts[1][None, :]
    assert int(per_position.sum()) == (size + 2 * p) ** 2
    if 2 * p < size:
        assert set(per_position.unique().tolist()) <= {1, 2, 4}
    assert int(per_position.max()) <= 9
    x = _input(c, size, dtype, 3).requires_grad_()
    dy = _input(c, size + 2 * p, dtype, 4, integers=True)
    F.pad(x, (p,) * 4, mode="reflect").backward(dy)
    got = backward_by_gather(dy, p)
    assert got.dtype == dtype and torch.equal(got, x.grad)


@pytest.mark.parametrize("p,size", [(1, 2), (1, 8), (3, 4), (3, 17)])
def test_gather_mirror_within_f32_sums_of_autograd_in_float64(p, size):
    """On random gradients the mirror's f32 sums (1 to 9 terms) lie within
    8 roundings of f32 of the sum of |terms| from autograd in float64."""
    dy = _input(5, size + 2 * p, torch.float32, 5)
    x = torch.zeros(2, 5, size, size, dtype=torch.float64, requires_grad=True)
    F.pad(x, (p,) * 4, mode="reflect").backward(dy.double())
    scale = torch.zeros_like(x)
    y = F.pad(scale.requires_grad_(), (p,) * 4, mode="reflect")
    y.backward(dy.double().abs())
    got = backward_by_gather(dy, p).double()
    bound = 8 * torch.finfo(torch.float32).eps * scale.grad
    assert bool(((got - x.grad).abs() <= bound).all())


class _OnCuda:
    """A CPU tensor that says it lies on the card: what ``reflect_pad`` and
    the kernels' checks read of a tensor, and nothing more."""

    device = torch.device("cuda")

    def __init__(self, t):
        self.t = t
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self.t.dim()

    def element_size(self):
        return self.t.element_size()

    def is_contiguous(self, memory_format=torch.contiguous_format):
        return self.t.is_contiguous(memory_format=memory_format)


def _nhwc(shape, dtype=torch.bfloat16):
    b, c, h, w = shape
    return torch.zeros(b, h, w, c, dtype=dtype).permute(0, 3, 1, 2)


# (input, p, where it goes: "kernels", "plain", or the error raised)
ROUTES = {
    "channels_last bf16": (_OnCuda(_nhwc((2, 8, 5, 6))), 1, "kernels"),
    "channels_last f32, p = H - 1": (
        _OnCuda(_nhwc((2, 3, 4, 6), torch.float32)), 3, "kernels"),
    "channels_last f16": (_OnCuda(_nhwc((2, 8, 5, 6), torch.float16)), 1,
                          "kernels"),
    "NCHW": (_OnCuda(torch.zeros(2, 8, 5, 6, dtype=torch.bfloat16)), 1,
             ValueError),
    "a slice that is not channels_last": (
        _OnCuda(_nhwc((2, 8, 5, 6))[:, :4]), 1, ValueError),
    "p == H": (_OnCuda(_nhwc((2, 8, 3, 6))), 3, ValueError),
    "p > W": (_OnCuda(_nhwc((2, 8, 6, 2))), 3, ValueError),
    "float64": (_OnCuda(_nhwc((2, 8, 5, 6), torch.float64)), 1, TypeError),
    "3-D": (_OnCuda(torch.zeros(8, 5, 6)), 1, ValueError),
    "on the CPU": (_nhwc((2, 8, 5, 6)), 1, "plain"),
    "NCHW on the CPU": (torch.zeros(2, 8, 5, 6), 1, "plain"),
    "float64 on the CPU": (torch.zeros(2, 8, 5, 6, dtype=torch.float64), 1,
                           "plain"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routes_by_what_the_input_shows(case, monkeypatch):
    """By the device alone: a CPU tensor of any layout or type goes to
    ATen's pad, a CUDA tensor to the kernels, whose wrapper raises on a
    layout, type, rank or p they do not take; no CUDA tensor falls back
    to the plain version."""
    x, p, want = ROUTES[case]

    def kernels(x, p):
        rp._check(x, "reflect_pad", p, *x.shape[-2:])
        return "kernels"

    plain = []

    def ref(x, p):
        plain.append(p)
        return F.pad(x, (p,) * 4, mode="reflect")

    monkeypatch.setattr(rp._ReflectPad, "apply", kernels)
    monkeypatch.setattr(rp, "reflect_pad_ref", ref)
    if isinstance(want, type):
        with pytest.raises(want):
            rp.reflect_pad(x, p)
    elif want == "kernels":
        assert rp.reflect_pad(x, p) == "kernels"
    else:
        assert torch.equal(rp.reflect_pad(x, p),
                           F.pad(x, (p,) * 4, mode="reflect"))
    assert bool(plain) == (want == "plain")


def test_other_devices_raise():
    """A device with neither kernels nor a plain path raises."""
    x = _OnCuda(_nhwc((2, 8, 5, 6)))
    x.device = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        rp.reflect_pad(x, 1)


@pytest.mark.parametrize("c,dtype,offset,want", [
    (256, torch.bfloat16, 0, 16), (512, torch.bfloat16, 0, 16),
    (64, torch.bfloat16, 0, 16), (24, torch.float32, 0, 16),
    (42, torch.float32, 0, 8), (6, torch.float32, 0, 8),
    (3, torch.float32, 0, 4), (3, torch.bfloat16, 0, 2),
    (6, torch.float16, 0, 4), (256, torch.bfloat16, 1, 2),
    (256, torch.bfloat16, 2, 4), (24, torch.float32, 2, 8)])
def test_vector_width_from_channels_and_address(c, dtype, offset, want):
    """The widest of 16, 8, 4 and 2 bytes that divides a pixel and the
    base address, at least an element."""
    flat = torch.zeros(offset + 4 * c, dtype=dtype)
    assert flat.data_ptr() % 16 == 0
    x = flat[offset:].view(1, 2, 2, c).permute(0, 3, 1, 2)
    assert rp.vector_bytes(c * x.element_size(), x) == want


def test_kernel_path_wiring_with_the_mirror(monkeypatch):
    """The autograd wiring of the kernels' path, with the plain pad and the
    gather mirror standing in for the two kernels: output and gradient
    equal autograd of ``F.pad``, the gradient comes back channels_last from
    an NCHW upstream gradient, and each kernel counts one launch."""
    def forward(x, p):
        trace.count("reflect_pad.launches")
        return F.pad(x, (p,) * 4, mode="reflect").contiguous(
            memory_format=torch.channels_last)

    def backward(dy, p):
        assert dy.is_contiguous(memory_format=torch.channels_last)
        trace.count("reflect_pad_bwd.launches")
        return backward_by_gather(dy, p)

    monkeypatch.setattr(rp, "reflect_pad_forward_cuda", forward)
    monkeypatch.setattr(rp, "reflect_pad_backward_cuda", backward)
    x = _input(6, 9, torch.float32, 6, integers=True)
    dy = torch.randint(-8, 9, (2, 6, 15, 15)).float()  # NCHW
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    before = [trace.counters().get(k, 0)
              for k in ("reflect_pad.launches", "reflect_pad_bwd.launches")]
    y = rp._ReflectPad.apply(a, 3)
    want = F.pad(b, (3,) * 4, mode="reflect")
    assert torch.equal(y, want)
    y.backward(dy)
    want.backward(dy)
    assert torch.equal(a.grad, b.grad)
    assert a.grad.is_contiguous(memory_format=torch.channels_last)
    after = [trace.counters().get(k, 0)
             for k in ("reflect_pad.launches", "reflect_pad_bwd.launches")]
    assert [n - m for n, m in zip(after, before)] == [1, 1]


def _with_reflection_pad2d(net: nn.Module) -> nn.Module:
    """A copy of ``net`` with each ReflectPad2d replaced by the
    ``nn.ReflectionPad2d`` it stands for."""
    net = copy.deepcopy(net)
    for name, module in list(net.named_modules()):
        for child_name, child in list(module.named_children()):
            if isinstance(child, tl.ReflectPad2d):
                setattr(module, child_name,
                        nn.ReflectionPad2d(child.padding))
    return net


TINY = dict(norm=tl.NormConfig(), compute_dtype=None)
NETS = {
    "Generator": lambda: Generator(ngf=8, n_blocks=2, **TINY),
    "D_PB": lambda: Discriminator(6, ndf=8, n_blocks=2, **TINY),
    "D_PP": lambda: Discriminator(24, ndf=8, n_blocks=2, **TINY),
    "ResnetGenerator": lambda: ResnetGenerator(ngf=8, n_blocks=2, **TINY),
}


@pytest.mark.parametrize("name", list(NETS))
def test_reflect_pad2d_keeps_every_state_dict_key(name):
    """The new module holds nothing: the nets' state_dict keys, and so
    the reference checkpoints' layout, are those of nn.ReflectionPad2d's."""
    torch.manual_seed(0)
    net = NETS[name]()
    pads = [m for m in net.modules() if isinstance(m, tl.ReflectPad2d)]
    assert pads and not any(isinstance(m, nn.ReflectionPad2d)
                            for m in net.modules())
    assert list(net.state_dict()) == list(
        _with_reflection_pad2d(net).state_dict())


def test_tiny_gan_forward_backward_equals_reflection_pad2d():
    """A tiny G and D_PB, train mode, forward and backward in f32 (dropout
    off): outputs and every gradient equal those of the same nets built
    with nn.ReflectionPad2d, bit for bit."""
    torch.manual_seed(0)
    g = Generator(ngf=8, n_blocks=2, use_dropout=False, **TINY)
    d = Discriminator(6, ndf=8, n_blocks=2, use_dropout=False, **TINY)
    nets = [(g, d), (_with_reflection_pad2d(g), _with_reflection_pad2d(d))]
    gen = torch.Generator().manual_seed(7)
    inputs = [torch.rand(2, 16, 16, c, generator=gen) * 2 - 1
              for c in (3, 42, 6)]
    results = []
    for gnet, dnet in nets:
        xs = [t.clone().requires_grad_() for t in inputs]
        fake = gnet(xs)
        logits = dnet(torch.cat([fake, xs[0]], -1))
        (logits.square().mean() + fake.abs().mean()).backward()
        results.append([fake, logits] + [t.grad for t in xs]
                       + [p.grad for net in (gnet, dnet)
                          for p in net.parameters()])
    assert all(a is not None and torch.equal(a, b)
               for a, b in zip(*results))
