"""Per-channel BatchNorm moments (counterpart of mmhand_tpu/ops/bn_stats.py).

``bn_moments(x)`` gives the f32 (mean, mean of squares) per channel of an
NCHW activation, the statistics every train-mode ``BatchNorm2d`` of the port
normalizes with.  Underneath, ``bn_sums`` computes the f32 (sum, sum of
squares) and ``bn_sums_backward`` its analytic gradient
``dx = g1 + 2 g2 x`` (mmhand_tpu/ops/bn_stats.py:73-77), joined by an
``autograd.Function``.

Both wrappers dispatch on where ``x`` lies: a CPU tensor goes to the plain
version beside them, a CUDA tensor to the hand-written kernels K2 and K2b in
``csrc/bn_stats.cu``, built at first use by ``ops._build``.  The kernels take
a 4-D tensor in ``channels_last`` memory, which is the (N = B*H*W, C)
row-major view, in float32, bfloat16 or float16; anything else raises, with
no silent copy.  Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def bn_sums_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch per-channel (sum, sum of squares) of (B, C, H, W), f32."""
    xf = x.float()
    return xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))


def bn_sums_backward_ref(x: torch.Tensor, g1: torch.Tensor,
                         g2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gradient of ``bn_sums_ref``: g1 + 2 g2 x in f32, cast to
    x's dtype (mmhand_tpu/ops/bn_stats.py:73-77)."""
    shape = (1, -1, 1, 1)
    dx = g1.float().view(shape) + 2.0 * g2.float().view(shape) * x.float()
    return dx.to(x.dtype)


def rows_view(x: torch.Tensor) -> tuple[int, int]:
    """(N, C) of the row-major view the kernels read; raises on a tensor
    they do not take."""
    if x.dim() != 4:
        raise ValueError(f"bn_sums: x must be 4-D NCHW, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bn_sums: x must be float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bn_sums: x must be in channels_last memory (the "
                         "(N, C) row-major view); a BatchNorm input in another "
                         "layout is a fault of the module that made it")
    b, c, h, w = x.shape
    return b * h * w, c


@functools.lru_cache(maxsize=None)
def _kernels():
    from mmhand_torch.ops._build import load_library

    lib = load_library()
    scratch = lib.mmhand_bn_sums_scratch
    scratch.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    scratch.restype = ctypes.c_int64
    forward = lib.mmhand_bn_sums
    forward.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p]
    forward.restype = ctypes.c_int
    backward = lib.mmhand_bn_sums_backward
    backward.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                         ctypes.c_int, ctypes.c_void_p]
    backward.restype = ctypes.c_int
    return scratch, forward, backward


def _bn_sums_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n, c = rows_view(x)
    code = _DTYPE_CODES[x.dtype]
    scratch_floats, forward, _ = _kernels()
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        scratch = torch.empty(scratch_floats(n, c, code),
                              dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(x.data_ptr(), code, n, c, scratch.data_ptr(),
                      out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bn_sums kernel launch failed: cudaError {err}")
    bn_sums.launches += 1
    return out[0], out[1]


def _bn_sums_backward_cuda(x: torch.Tensor, g1: torch.Tensor,
                           g2: torch.Tensor) -> torch.Tensor:
    n, c = rows_view(x)
    g1 = g1.to(dtype=torch.float32).contiguous()
    g2 = g2.to(dtype=torch.float32).contiguous()
    if g1.shape != (c,) or g2.shape != (c,):
        raise ValueError(f"bn_sums_backward: gradients must be ({c},), got "
                         f"{tuple(g1.shape)} and {tuple(g2.shape)}")
    _, _, backward = _kernels()
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = backward(x.data_ptr(), _DTYPE_CODES[x.dtype], g1.data_ptr(),
                       g2.data_ptr(), dx.data_ptr(), n, c, stream)
    if err != 0:
        raise RuntimeError(f"bn_sums_backward kernel launch failed: "
                           f"cudaError {err}")
    bn_sums_backward.launches += 1
    return dx


def bn_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel f32 (sum, sum of squares) of a (B, C, H, W) tensor: K2 on
    a CUDA device (channels_last input), the plain version on the CPU."""
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


bn_sums.launches = 0
bn_sums_backward.launches = 0


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
    """Per-channel (mean, mean of squares) of a (B, C, H, W) tensor, f32
    (mmhand_tpu/ops/bn_stats.py:152-166)."""
    n = x.numel() // x.shape[1]
    s1, s2 = _BnSums.apply(x)
    return s1 / n, s2 / n
