"""Reflect padding of a (B, C, H, W) activation, the pad before each VALID
conv of the GAN's nets (``models.layers.pad_conv``).

``reflect_pad(x, p)`` pads H and W by ``p`` on each side, mirroring about
the edge pixel, as ``F.pad(x, (p,) * 4, mode="reflect")`` does, in x's type
(the f32 stems stay f32 under autocast, as ``nn.ReflectionPad2d`` keeps
them).  Its backward sums the gradient of every padded position into the
input position it copies.

The path depends on the device alone: on the CPU the plain version,
ATen's pad (``reflect_pad_ref``); on CUDA the hand-written kernels of
``csrc/reflect_pad.cu`` (``reflect_pad_kernel`` forward,
``reflect_pad_backward_kernel`` backward), built at first use by
``ops._build``, which take a tensor of four axes in ``channels_last``
memory, in float32, bfloat16 or float16, with p < min(H, W), keep its
layout both ways, and raise on anything else; any other device raises.
The kernels' wrappers count their launches in ``utils.trace``
(``reflect_pad.launches``, ``reflect_pad_bwd.launches``).

The backward kernel gathers: each input position sums, in f32, the 1 to 9
padded positions that copy it, in a fixed order, with no zero fill and no
atomics, so its result repeats bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from mmhand_torch.ops.bn_stats import _DTYPE_CODES
from mmhand_torch.utils import trace

VEC_BYTES = (16, 8, 4, 2)  # the widths a thread may move, widest first
_INT_MAX = 2 ** 31 - 1


def reflect_pad_ref(x: torch.Tensor, p: int) -> torch.Tensor:
    """Plain PyTorch reflect pad of H and W by ``p`` (ATen's, NCHW on the
    card)."""
    return F.pad(x, (p, p, p, p), mode="reflect")


def vector_bytes(pixel_bytes: int, *tensors: torch.Tensor) -> int:
    """The bytes a thread moves: the widest of ``VEC_BYTES`` that divides a
    pixel's ``pixel_bytes`` and the base address of every tensor, at least
    an element; 16 at every site of the GAN's blocks, 4 or 8 at its f32
    stems of 3, 6 and 42 channels."""
    elem = tensors[0].element_size()
    for vec in VEC_BYTES:
        if (vec >= elem and pixel_bytes % vec == 0
                and all(t.data_ptr() % vec == 0 for t in tensors)):
            return vec
    raise ValueError(f"reflect_pad: no vector width for {pixel_bytes}-byte "
                     "pixels at these addresses")


def _check(x: torch.Tensor, what: str, p: int, h: int, w: int) -> None:
    """Raises on a tensor ``x`` that the kernels do not take, or a padding
    ``p`` of an (h, w) input that they do not."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be 4-D NCHW, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: x must be float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what}: x must be in channels_last memory")
    b, c = x.shape[:2]
    if not 0 <= p < min(h, w):
        raise ValueError(f"{what}: padding {p} must be below H and W, "
                         f"{(h, w)}")
    if b > _INT_MAX or h + 2 * p > _INT_MAX or (
            (w + 2 * p) * c * x.element_size() >= 2 ** 30):
        raise ValueError(f"{what}: {tuple(x.shape)} is too large")


@functools.lru_cache(maxsize=None)
def _kernels():
    from mmhand_torch.ops._build import load_library

    lib = load_library()
    forward = lib.mmhand_reflect_pad
    forward.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p])
    forward.restype = ctypes.c_int
    backward = lib.mmhand_reflect_pad_backward
    backward.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p])
    backward.restype = ctypes.c_int
    return forward, backward


def _padded(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.empty((x.shape[0], x.shape[1], h, w), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)


def reflect_pad_forward_cuda(x: torch.Tensor, p: int) -> torch.Tensor:
    """reflect_pad_kernel: the padded channels_last copy of ``x``."""
    b, c, h, w = x.shape
    _check(x, "reflect_pad", p, h, w)
    y = _padded(x, h + 2 * p, w + 2 * p)
    if y.numel() == 0:
        return y
    pixel = c * x.element_size()
    forward, _ = _kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(x.data_ptr(), y.data_ptr(), b, h, w, pixel,
                      vector_bytes(pixel, x, y), p, stream)
    if err != 0:
        raise RuntimeError(f"reflect_pad kernel launch failed: cudaError {err}")
    trace.count("reflect_pad.launches")
    return y


def reflect_pad_backward_cuda(dy: torch.Tensor, p: int) -> torch.Tensor:
    """reflect_pad_backward_kernel: the input's gradient from ``dy``, the
    padded output's, both channels_last."""
    b, c, ho, wo = dy.shape
    h, w = ho - 2 * p, wo - 2 * p
    _check(dy, "reflect_pad_backward", p, h, w)
    dx = _padded(dy, h, w)
    if dx.numel() == 0:
        return dx
    _, backward = _kernels()
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream(dy.device).cuda_stream
        err = backward(dy.data_ptr(), dx.data_ptr(), _DTYPE_CODES[dy.dtype],
                       b, h, w, c, vector_bytes(c * dy.element_size(), dy, dx),
                       p, stream)
    if err != 0:
        raise RuntimeError(f"reflect_pad_backward kernel launch failed: "
                           f"cudaError {err}")
    trace.count("reflect_pad_bwd.launches")
    return dx


class _ReflectPad(torch.autograd.Function):
    """The kernels' pad with the gather backward; nothing saved but p."""

    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return reflect_pad_forward_cuda(x, p)

    @staticmethod
    def backward(ctx, dy):
        # autograd's gradient of the output, which the kernel reads in the
        # output's layout
        dy = dy.contiguous(memory_format=torch.channels_last)
        return reflect_pad_backward_cuda(dy, ctx.p), None


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect pad of H and W by ``p`` on each side, in x's type: ATen's pad
    on the CPU, the kernels on CUDA."""
    if x.device.type == "cpu":
        return reflect_pad_ref(x, p)
    if x.device.type == "cuda":
        return _ReflectPad.apply(x, p)
    raise ValueError(f"reflect_pad: no kernel for device {x.device}")
