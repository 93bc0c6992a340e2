"""Train-mode BatchNorm on the card: the per-channel moments (counterpart
of mmhand_tpu/ops/bn_stats.py) and the normalize that follows them.

``bn_moments(x)`` gives the f32 (mean, mean of squares) per channel of an
NCHW or NCDHW activation, the statistics every train-mode ``BatchNorm2d``
and ``BatchNorm3d`` of the port normalizes with.  Underneath, ``bn_sums``
computes the f32 (sum, sum of squares) and ``bn_sums_backward`` its
analytic gradient ``dx = g1 + 2 g2 x`` (mmhand_tpu/ops/bn_stats.py:73-77),
joined by an ``autograd.Function``.

``bn_apply(x, mean, mean_sq, weight, bias, eps)`` is the normalize, y =
((x - mean) * scale) + bias with scale = rsqrt(max(mean_sq - mean^2, 0) +
eps) * weight in f32, stored in x's type (mmhand_tpu/models/layers.py:
190-192), one ``autograd.Function`` whose backward forms dx = dy * scale
and the gradients of mean, mean_sq, weight and bias from two per-channel
sums (``bn_apply_forward``, ``bn_apply_backward``).

Every wrapper dispatches on where ``x`` lies: a CPU tensor goes to the
plain version beside it, a CUDA tensor to the hand-written kernels in
``csrc/bn_stats.cu`` (K2 and K2b for the moments, ``bn_apply_kernel`` and
``bn_apply_backward_kernel`` for the normalize), built at first use by
``ops._build``.  The kernels take a 4-D tensor in ``channels_last`` memory
or a 5-D one in ``channels_last_3d``, which is the (N = B*H*W or B*D*H*W,
C) row-major view, in float32, bfloat16 or float16; anything else raises,
with no silent copy.  Each wrapper counts its kernel launches in a counter
of ``utils.trace`` (``k2.launches``, ``k2b.launches``,
``bn_apply.launches``, ``bn_apply_bwd.launches``).

K2's cut of the view (``sums_plan``: 16-byte loads at every C through
super-rows of lcm(C, vec) elements, one wave of blocks) is decided
here and passed to the kernel; ``bn_sums_by_plan`` sums under the same
plan with the kernel's index arithmetic in plain PyTorch, so that the CPU
tests reach it.  The normalize's kernels walk the same plan with no head:
the wrapper hands them 16-byte aligned tensors, copying a view whose base
is not (no convolution's output is such a view).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from mmhand_torch.utils import trace

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _other_axes(x: torch.Tensor) -> tuple[int, ...]:
    return (0,) + tuple(range(2, x.dim()))


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over ``x``'s channel axis."""
    return v.view((1, -1) + (1,) * (x.dim() - 2))


def moments_dtype(x: torch.Tensor) -> torch.dtype:
    """The type the moments of ``x`` are taken in: f32, or x's own where it
    is wider (float64 on the CPU), as flax promotes them."""
    return torch.promote_types(x.dtype, torch.float32)


def bn_sums_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch per-channel (sum, sum of squares) of (B, C, ...), f32
    (``moments_dtype``)."""
    xf = x.to(moments_dtype(x))
    return xf.sum(_other_axes(x)), (xf * xf).sum(_other_axes(x))


def bn_sums_backward_ref(x: torch.Tensor, g1: torch.Tensor,
                         g2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gradient of ``bn_sums_ref``: g1 + 2 g2 x in f32
    (``moments_dtype``), cast to x's dtype (mmhand_tpu/ops/bn_stats.py:
    73-77)."""
    dt = moments_dtype(x)
    dx = (_per_channel(g1.to(dt), x)
          + 2.0 * _per_channel(g2.to(dt), x) * x.to(dt))
    return dx.to(x.dtype)


def _layout(x: torch.Tensor) -> torch.memory_format:
    return torch.channels_last if x.dim() == 4 else torch.channels_last_3d


def rows_view(x: torch.Tensor, what: str = "bn_sums") -> tuple[int, int]:
    """(N, C) of the row-major view the kernels read; raises on a tensor
    they do not take, naming ``what`` refused it."""
    if x.dim() not in (4, 5):
        raise ValueError(f"{what}: x must be 4-D NCHW or 5-D NCDHW, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: x must be float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    if not x.is_contiguous(memory_format=_layout(x)):
        raise ValueError(f"{what}: x must be in channels_last memory "
                         "(channels_last_3d for 5-D; the (N, C) row-major "
                         "view); a BatchNorm input in another layout is a "
                         "fault of the module that made it")
    c = x.shape[1]
    return x.numel() // c, c


VEC_BYTES = 16       # one load of K2
THREADS = 1024       # threads of a K2 block, one block per SM
MAX_LANES = 8        # threads across a channel tile
MAX_CHUNKS = 256     # blocks along the rows of a tile
MAX_TICKETS = 8192   # tiles + 1 at most


class SumsPlan(NamedTuple):
    """K2's cut of the flat (N * C) array, field for field ``SumsPlan`` in
    csrc/bn_stats.cu.  The body after ``head`` elements is ``super_rows``
    super-rows of ``width`` = lcm(C, vec) elements, each ``vectors``
    16-byte loads, slot s holding channel (head + s) mod C; what follows is
    the tail.  Block (chunk, tile) reads vectors tile * lanes + lane of
    ``rows_per_chunk`` super-rows."""
    n_elems: int
    c: int
    head: int
    width: int
    vectors: int
    lanes: int
    tiles: int
    super_rows: int
    chunks: int
    rows_per_chunk: int

    @property
    def slots(self) -> int:
        """Slots of one tile: its lanes' elements."""
        return self.lanes * (self.width // self.vectors)

    @property
    def scratch_floats(self) -> int:
        """f32 scratch: a (2, slots) partial per block, then the slot sums
        of each tile."""
        return (self.chunks + 1) * self.tiles * 2 * self.slots

    @property
    def tail(self) -> int:
        """First element after the last whole super-row."""
        return self.head + self.super_rows * self.width


@functools.lru_cache(maxsize=4096)
def sums_plan(n: int, c: int, elem_bytes: int, head: int,
              sms: int) -> SumsPlan:
    """K2's plan for a (n, c) view of ``elem_bytes`` elements whose first
    ``head`` elements lie before a 16-byte boundary, on a card of ``sms``
    SMs: k = vec / gcd(C, vec) rows make a super-row of whole vectors;
    tiles of at most 8 lanes (128 bytes of a super-row) cover its vectors;
    one wave of one block per SM shares the super-rows, each tile's blocks
    along the rows, so that a tile's last block sums few partials."""
    vec = VEC_BYTES // elem_bytes
    total = n * c
    head = min(head, total)
    width = c * vec // math.gcd(c, vec)
    vectors = width // vec
    lanes = min(1 << (vectors - 1).bit_length(), MAX_LANES)
    tiles = -(-vectors // lanes)
    super_rows = (total - head) // width
    most = max(1, -(-super_rows // (THREADS // lanes)))
    chunks = min(max(1, sms // tiles), most, MAX_CHUNKS)
    rows_per_chunk = max(1, -(-super_rows // chunks))
    chunks = max(1, -(-super_rows // rows_per_chunk))
    if tiles + 1 > MAX_TICKETS or tiles > 65535:
        raise ValueError(f"bn_sums: no plan for C={c}: {tiles} channel tiles")
    return SumsPlan(total, c, head, width, vectors, lanes, tiles, super_rows,
                    chunks, rows_per_chunk)


def bn_sums_by_plan(x: torch.Tensor, plan: SumsPlan
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of squares) per channel of the (N, C) view of ``x`` as K2
    computes them under ``plan``, with bn_sums_kernel's index arithmetic
    (csrc/bn_stats.cu): block (chunk, tile) reads vector tile * lanes +
    lane of its chunk's super-rows and stores its partial at scratch
    chunk * tiles * 2 tw + tile * 2 tw; the tile's last block sums the
    chunks in order; a C that is a multiple of vec maps slot s to channel
    (head + s) mod C, any other C folds through ``fold``'s slots s0 + m C,
    s0 = (ch - head) mod C, at (s & ~(tw - 1)) * 2 + (s & (tw - 1)); then
    ``add_edges`` adds the head and the tail.  f32 sums, in another order
    within a block than the kernel's."""
    c, tw, head, tail = plan.c, plan.slots, plan.head, plan.tail
    vec = plan.width // plan.vectors
    flat = x.permute(0, *range(2, x.dim()), 1).reshape(-1).float()
    row = plan.tiles * 2 * tw  # floats of one chunk's partials
    scratch = torch.zeros(plan.scratch_floats)
    body = flat[head:tail].view(plan.super_rows, plan.vectors, vec)
    out = torch.zeros(2, c)
    for tile in range(plan.tiles):
        v = tile * plan.lanes + torch.arange(plan.lanes)
        live = v < plan.vectors
        for chunk in range(plan.chunks):
            begin = chunk * plan.rows_per_chunk
            rows = body[begin:min(begin + plan.rows_per_chunk,
                                  plan.super_rows)][:, v[live]]
            part = torch.zeros(2, plan.lanes, vec)
            part[0, live] = rows.sum(0)
            part[1, live] = (rows * rows).sum(0)
            at = chunk * row + tile * 2 * tw
            scratch[at:at + 2 * tw] = part.reshape(-1)
        red = torch.zeros(2 * tw)
        for chunk in range(plan.chunks):
            at = chunk * row + tile * 2 * tw
            red += scratch[at:at + 2 * tw]
        if plan.width == c:
            s = tile * tw + torch.arange(tw)
            keep = s < plan.width
            ch = (head + s[keep]) % c if head else s[keep]
            out[0, ch] = red[:tw][keep]
            out[1, ch] = red[tw:][keep]
        else:
            at = plan.chunks * row + tile * 2 * tw
            scratch[at:at + 2 * tw] = red
    if plan.width != c:
        ch = torch.arange(c)
        s0 = ((ch - head) % c + c) % c if head else ch
        s = s0[:, None] + torch.arange(plan.width // c) * c
        at = (s & ~(tw - 1)) * 2 + (s & (tw - 1))
        slots = scratch[plan.chunks * row:]
        out[0] = slots[at].sum(1)
        out[1] = slots[at + tw].sum(1)
    # add_edges: channel ch's elements ch, ch + C, ... of the head, and
    # tail + ((ch - tail) mod C), ... of the tail; index n_elems is a zero
    padded = torch.cat([flat, flat.new_zeros(1)])
    ch = torch.arange(c)
    for first, lo, stop in ((ch, 0, head),
                            (tail + ((ch - tail) % c + c) % c, tail,
                             plan.n_elems)):
        e = first[:, None] + torch.arange(-(-(stop - lo) // c)) * c
        e = torch.where(e < stop, e, plan.n_elems)
        vals = padded[e]
        out[0] += vals.sum(1)
        out[1] += (vals * vals).sum(1)
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def _kernels():
    from mmhand_torch.ops._build import load_library

    lib = load_library()
    forward = lib.mmhand_bn_sums
    forward.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p]
    forward.restype = ctypes.c_int
    backward = lib.mmhand_bn_sums_backward
    backward.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                         ctypes.c_int, ctypes.c_void_p]
    backward.restype = ctypes.c_int
    return forward, backward


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _plan_args(plan: SumsPlan) -> ctypes.Array:
    return (ctypes.c_int64 * len(plan))(*plan)


# K2's tickets: one zeroed int32 array of MAX_TICKETS per (device, stream),
# which only that stream's launches touch and each launch leaves zero, so
# two launches that run at once on two streams never share a ticket.  A
# spare per device, made outside any CUDA graph capture, goes to the next
# stream that needs one: a stream first seen while a graph is captured
# (torch.cuda.graph's own capture stream) then needs no allocation and no
# memset inside the capture.  The limit: a CUDA graph keeps the tickets of
# the stream it was captured on.  torch.cuda.graph captures every graph on
# one shared stream, so such graphs share one array: their replays must not
# overlap one another, nor overlap eager K2 launches on a stream that has
# that stream's handle (torch's stream pool may hand it out again).
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
_SPARE_TICKETS: dict[int, torch.Tensor] = {}


def _zeroed_tickets(device: torch.device) -> torch.Tensor:
    tickets = torch.zeros(MAX_TICKETS, dtype=torch.int32, device=device)
    # zero before a launch on another stream reads it; once per stream
    torch.cuda.current_stream(device).synchronize()
    return tickets


def _tickets(device: torch.device, stream: int) -> torch.Tensor:
    """The tickets of ``stream`` (a raw handle) on ``device``; call it under
    ``torch.cuda.device(device)``."""
    tickets = _TICKETS.get((device.index, stream))
    if tickets is not None:
        return tickets
    capturing = torch.cuda.is_current_stream_capturing()
    tickets = _SPARE_TICKETS.pop(device.index, None)
    if tickets is None:
        if capturing:
            raise RuntimeError(
                "bn_sums: a CUDA graph captures K2's first launch on a new "
                "stream, and the spare tickets are taken; call bn_sums once "
                "on that stream before the capture")
        tickets = _zeroed_tickets(device)
    _TICKETS[device.index, stream] = tickets
    if not capturing:
        _SPARE_TICKETS[device.index] = _zeroed_tickets(device)
    return tickets


def _bn_sums_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n, c = rows_view(x)
    ptr, size = x.data_ptr(), x.element_size()
    if ptr % size:
        raise ValueError("bn_sums: x is not aligned to its element size")
    plan = sums_plan(n, c, size, -ptr % VEC_BYTES // size,
                     _sm_count(x.device.index))
    forward, _ = _kernels()
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                              device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(ptr, _DTYPE_CODES[x.dtype], _plan_args(plan),
                      scratch.data_ptr(), out.data_ptr(),
                      _tickets(x.device, stream).data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bn_sums kernel launch failed: cudaError {err}")
    trace.count("k2.launches")
    return out[0], out[1]


def _bn_sums_backward_cuda(x: torch.Tensor, g1: torch.Tensor,
                           g2: torch.Tensor) -> torch.Tensor:
    n, c = rows_view(x)
    g1 = g1.to(dtype=torch.float32).contiguous()
    g2 = g2.to(dtype=torch.float32).contiguous()
    if g1.shape != (c,) or g2.shape != (c,):
        raise ValueError(f"bn_sums_backward: gradients must be ({c},), got "
                         f"{tuple(g1.shape)} and {tuple(g2.shape)}")
    _, backward = _kernels()
    dx = torch.empty_like(x, memory_format=_layout(x))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = backward(x.data_ptr(), _DTYPE_CODES[x.dtype], g1.data_ptr(),
                       g2.data_ptr(), dx.data_ptr(), n, c, stream)
    if err != 0:
        raise RuntimeError(f"bn_sums_backward kernel launch failed: "
                           f"cudaError {err}")
    trace.count("k2b.launches")
    return dx


def bn_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel f32 (sum, sum of squares) of a (B, C, H, W) or
    (B, C, D, H, W) tensor: K2 on a CUDA device (channels_last or
    channels_last_3d input), the plain version on the CPU."""
    if x.device.type == "cpu":
        return bn_sums_ref(x)
    if x.device.type == "cuda":
        return _bn_sums_cuda(x)
    raise ValueError(f"bn_sums: no kernel for device {x.device}")


def bn_sums_backward(x: torch.Tensor, g1: torch.Tensor,
                     g2: torch.Tensor) -> torch.Tensor:
    """dx = g1 + 2 g2 x, in x's dtype and layout: K2b on a CUDA device, the
    plain version on the CPU."""
    if x.device.type == "cpu":
        return bn_sums_backward_ref(x, g1, g2)
    if x.device.type == "cuda":
        return _bn_sums_backward_cuda(x, g1, g2)
    raise ValueError(f"bn_sums_backward: no kernel for device {x.device}")


class _BnSums(torch.autograd.Function):
    """(sum, sum of squares) with the analytic backward, as the JAX
    ``custom_vjp`` of ``_sums_2d_pallas`` (mmhand_tpu/ops/bn_stats.py:115-149)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return bn_sums(x)

    @staticmethod
    def backward(ctx, g1, g2):
        (x,) = ctx.saved_tensors
        return bn_sums_backward(x, g1, g2)


def bn_moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, mean of squares) of a (B, C, H, W) or
    (B, C, D, H, W) tensor, f32 (float64 for a float64 tensor on the CPU;
    mmhand_tpu/ops/bn_stats.py:152-166)."""
    n = x.numel() // x.shape[1]
    s1, s2 = _BnSums.apply(x)
    return s1 / n, s2 / n


def _inv_std(mean: torch.Tensor, mean_sq: torch.Tensor,
             eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(E[x^2] - E[x]^2 before the clamp, rsqrt(var + eps)) per channel."""
    raw = mean_sq - mean * mean
    return raw, torch.rsqrt(torch.clamp(raw, min=0.0) + eps)


def bn_apply_ref(x: torch.Tensor, mean: torch.Tensor, mean_sq: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """Plain PyTorch normalize: ((x - mean) * scale) + bias in the moments'
    type, scale = rsqrt(max(mean_sq - mean^2, 0) + eps) * weight, cast to
    x's dtype."""
    _, r = _inv_std(mean, mean_sq, eps)
    y = ((x.to(mean.dtype) - _per_channel(mean, x))
         * _per_channel(r * weight, x))
    return (y + _per_channel(bias, x)).to(x.dtype)


def bn_apply_backward_ref(dy: torch.Tensor, x: torch.Tensor,
                          mean: torch.Tensor, mean_sq: torch.Tensor,
                          weight: torch.Tensor, eps: float
                          ) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch gradients of ``bn_apply_ref``: (dx, d_mean, d_mean_sq,
    d_weight, d_bias).  dx = dy * scale in x's dtype; with a = sum dy and
    b = sum dy (x - mean) per channel, d_bias = a, d_weight = b r, d_var =
    -0.5 b weight r^3 where mean_sq - mean^2 >= 0 (torch.clamp's mask) and
    0 elsewhere, d_mean_sq = d_var, d_mean = -(scale a) - 2 mean d_var."""
    raw, r = _inv_std(mean, mean_sq, eps)
    scale = r * weight
    g = dy.to(mean.dtype)
    a = g.sum(_other_axes(x))
    b = (g * (x.to(mean.dtype) - _per_channel(mean, x))).sum(_other_axes(x))
    dx = (g * _per_channel(scale, x)).to(x.dtype)
    d_var = torch.where(raw >= 0, -0.5 * (b * weight) * (r * r * r), 0.0)
    return dx, -(scale * a) - 2.0 * mean * d_var, d_var, b * r, a


@functools.lru_cache(maxsize=None)
def _apply_kernels():
    from mmhand_torch.ops._build import load_library

    lib = load_library()
    forward = lib.mmhand_bn_apply
    forward.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                        + [ctypes.c_void_p] * 4 + [ctypes.c_float]
                        + [ctypes.c_void_p] * 3)
    forward.restype = ctypes.c_int
    backward = lib.mmhand_bn_apply_backward
    backward.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                         + [ctypes.c_void_p] * 3 + [ctypes.c_float]
                         + [ctypes.c_void_p] * 6)
    backward.restype = ctypes.c_int
    return forward, backward


def _channel_f32(c: int, *vectors: torch.Tensor) -> list[torch.Tensor]:
    """Per-channel vectors as contiguous f32 (C,), as the kernels read them."""
    out = [v.to(dtype=torch.float32).contiguous() for v in vectors]
    if any(v.shape != (c,) for v in out):
        raise ValueError(f"bn_apply: per-channel vectors must be ({c},), got "
                         f"{[tuple(v.shape) for v in out]}")
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it in its layout where its base is not 16-byte
    aligned: the normalize's kernels load and store 16 bytes at a time."""
    if t.data_ptr() % VEC_BYTES == 0:
        return t
    return torch.empty_like(t, memory_format=_layout(t)).copy_(t)


def _apply_plan_of(x: torch.Tensor, what: str) -> SumsPlan:
    """K2's plan for the (N, C) view of ``x``, with no head."""
    n, c = rows_view(x, what)
    return sums_plan(n, c, x.element_size(), 0, _sm_count(x.device.index))


def _bn_apply_cuda(x, mean, mean_sq, weight, bias, eps) -> torch.Tensor:
    plan = _apply_plan_of(x, "bn_apply")
    x = _aligned(x)
    stats = _channel_f32(plan.c, mean, mean_sq, weight, bias)
    forward, _ = _apply_kernels()
    y = torch.empty_like(x, memory_format=_layout(x))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(x.data_ptr(), _DTYPE_CODES[x.dtype],
                      *(v.data_ptr() for v in stats), eps, y.data_ptr(),
                      _plan_args(plan), stream)
    if err != 0:
        raise RuntimeError(f"bn_apply kernel launch failed: cudaError {err}")
    trace.count("bn_apply.launches")
    return y


def _bn_apply_backward_cuda(dy, x, mean, mean_sq, weight, eps):
    plan = _apply_plan_of(x, "bn_apply_backward")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"bn_apply_backward: dy {tuple(dy.shape)} {dy.dtype} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    # autograd's gradient of y, which the kernel reads in y's layout
    x, dy = _aligned(x), _aligned(dy.contiguous(memory_format=_layout(x)))
    stats = _channel_f32(plan.c, mean, mean_sq, weight)
    _, backward = _apply_kernels()
    dx = torch.empty_like(x, memory_format=_layout(x))
    grads = torch.empty(4, plan.c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                              device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = backward(x.data_ptr(), dy.data_ptr(), _DTYPE_CODES[x.dtype],
                       *(v.data_ptr() for v in stats), eps, dx.data_ptr(),
                       scratch.data_ptr(), grads.data_ptr(),
                       _tickets(x.device, stream).data_ptr(),
                       _plan_args(plan), stream)
    if err != 0:
        raise RuntimeError(f"bn_apply_backward kernel launch failed: "
                           f"cudaError {err}")
    trace.count("bn_apply_bwd.launches")
    return (dx, *grads.unbind())


def bn_apply_forward(x: torch.Tensor, mean: torch.Tensor,
                     mean_sq: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The normalize of ``bn_apply_ref``, in x's dtype and layout:
    bn_apply_kernel on a CUDA device, the plain version on the CPU."""
    if x.device.type == "cpu":
        return bn_apply_ref(x, mean, mean_sq, weight, bias, eps)
    if x.device.type == "cuda":
        return _bn_apply_cuda(x, mean, mean_sq, weight, bias, eps)
    raise ValueError(f"bn_apply: no kernel for device {x.device}")


def bn_apply_backward(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                      mean_sq: torch.Tensor, weight: torch.Tensor,
                      eps: float) -> tuple[torch.Tensor, ...]:
    """(dx, d_mean, d_mean_sq, d_weight, d_bias) of ``bn_apply_backward_ref``:
    bn_apply_backward_kernel on a CUDA device (f32 gradients), the plain
    version on the CPU."""
    if x.device.type == "cpu":
        return bn_apply_backward_ref(dy, x, mean, mean_sq, weight, eps)
    if x.device.type == "cuda":
        return _bn_apply_backward_cuda(dy, x, mean, mean_sq, weight, eps)
    raise ValueError(f"bn_apply_backward: no kernel for device {x.device}")


class _BnApply(torch.autograd.Function):
    """The normalize with its analytic backward: x, mean, mean_sq and weight
    are saved (x is K2's saved input already), no full-size temporary."""

    @staticmethod
    def forward(ctx, x, mean, mean_sq, weight, bias, eps):
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        ctx.save_for_backward(x, mean, mean_sq, weight)
        return bn_apply_forward(x, mean, mean_sq, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, mean, mean_sq, weight = ctx.saved_tensors
        dx, d_mean, d_mean_sq, d_weight, d_bias = bn_apply_backward(
            dy, x, mean, mean_sq, weight, ctx.eps)
        return (dx, d_mean.to(mean.dtype), d_mean_sq.to(mean_sq.dtype),
                d_weight.to(weight.dtype), d_bias.to(ctx.bias_dtype), None)


def bn_apply(x: torch.Tensor, mean: torch.Tensor, mean_sq: torch.Tensor,
             weight: torch.Tensor, bias: torch.Tensor,
             eps: float) -> torch.Tensor:
    """Train-mode BatchNorm's normalize of a (B, C, H, W) or (B, C, D, H, W)
    tensor by its per-channel (mean, mean of squares): ((x - mean) *
    scale) + bias, scale = rsqrt(max(mean_sq - mean^2, 0) + eps) * weight,
    in f32 (float64 with float64 moments on the CPU), in x's dtype, with the
    analytic backward (mmhand_tpu/models/layers.py:190-192)."""
    return _BnApply.apply(x, mean, mean_sq, weight, bias, eps)
