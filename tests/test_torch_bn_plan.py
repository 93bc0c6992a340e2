"""K2's plan (mmhand_torch/ops/bn_stats.py ``sums_plan``) and its fold, on
the CPU.

The kernel in csrc/bn_stats.cu reads the (N, C) view of a BatchNorm input
as super-rows of lcm(C, vec) elements, so that every C gets 16-byte loads,
and folds its slots back into channels; the wrapper decides that cut and
passes it in.  These tests hold the cut's invariants at many shapes, and
``bn_sums_by_plan`` (the same cut walked in plain PyTorch) against the
plain sums and against JAX ``bn_moments(method="pallas")`` (the Pallas
kernel in interpret mode), with N mod k != 0 and heads of 0 and vec - 1
elements.  Tolerance: f32 sums in another order, within 1e-5 of sum |x|
and of sum x^2, as the card tests hold K2.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmhand_torch.ops import bn_stats as tbn
from mmhand_tpu.ops.bn_stats import bn_moments as jax_bn_moments

H100_SMS = 132
SOURCE = Path(tbn.__file__).resolve().parent.parent / "csrc" / "bn_stats.cu"


def _check_plan(plan, n, c, elem_bytes, head):
    vec = tbn.VEC_BYTES // elem_bytes
    assert plan.n_elems == n * c and plan.c == c and plan.head == min(head, n * c)
    assert plan.width == math.lcm(c, vec) == plan.vectors * vec
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= tbn.MAX_LANES
    assert (plan.tiles - 1) * plan.lanes < plan.vectors <= plan.tiles * plan.lanes
    assert 0 <= plan.n_elems - plan.tail < plan.width
    rows = plan.super_rows
    assert rows == (plan.n_elems - plan.head) // plan.width
    # every super-row in one chunk, no chunk empty (but the one of an
    # empty body); one wave of blocks, one per SM
    assert plan.chunks * plan.rows_per_chunk >= rows
    assert rows == 0 or (plan.chunks - 1) * plan.rows_per_chunk < rows
    assert plan.chunks <= tbn.MAX_CHUNKS and plan.tiles + 1 <= tbn.MAX_TICKETS
    assert plan.chunks * plan.tiles <= max(H100_SMS, plan.tiles)
    # the fold: each channel owns width / C slots
    owners = np.bincount((plan.head + np.arange(plan.width)) % c, minlength=c)
    assert (owners == plan.width // c).all()


@pytest.mark.parametrize("n,c,elem_bytes,head", [
    (1 << 20, 64, 2, 0),            # the GAN step's largest site
    (1 << 16, 256, 2, 0),
    (1 << 14, 512, 2, 0),
    (8 * 64 ** 3, 1, 4, 0),         # the C=1 sites, f32
    (32 * 128 * 128, 1, 4, 3),      # ... at an unaligned base
    (8 * 256 * 256, 21, 4, 0),
    (2048, 2048, 2, 0),             # PoseResNet-50's widest
    (4551, 3, 2, 7),
    (4551, 5, 2, 1),
    (4551, 13, 4, 2),
    (3, 1, 4, 3),                   # everything in the head and tail
    (1, 1, 4, 3),                   # fewer elements than the head
    (1, 1, 2, 7),
    (0, 1, 4, 3),                   # nothing, at an unaligned base
    (0, 8, 2, 0)])                  # nothing at all
def test_plan_covers_the_array(n, c, elem_bytes, head):
    _check_plan(tbn.sums_plan(n, c, elem_bytes, head, H100_SMS), n, c,
                elem_bytes, head)


def test_plan_fields_are_the_kernels():
    """The kernel copies the plan as a struct of int64: the same fields in
    the same order, and the same limits."""
    src = SOURCE.read_text()
    struct = re.search(r"struct SumsPlan \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"int64_t (\w+);", struct)
    assert tuple(fields) == tbn.SumsPlan._fields
    for name, value in (("kSumThreads", tbn.THREADS),
                        ("kVecBytes", tbn.VEC_BYTES),
                        ("kSumLanes", tbn.MAX_LANES),
                        ("kMaxChunks", tbn.MAX_CHUNKS),
                        ("kMaxTickets", tbn.MAX_TICKETS)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) \
            == str(value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("c", [1, 2, 3, 5, 13, 21, 64, 256])
def test_fold_matches_plain_and_jax(c, dtype):
    """N = 4551 rows: N mod k != 0 for every k of 2, 4 and 8, several chunks
    and tiles; heads of 0 and vec - 1 elements."""
    x_nhwc = (np.random.RandomState(c).normal(size=(3, 37, 41, c)) * 1.5
              + 0.3).astype(np.float32)
    x = torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)
    n, size = x.numel() // c, x.element_size()
    vec = tbn.VEC_BYTES // size
    assert n % (vec // math.gcd(c, vec)) or vec // math.gcd(c, vec) == 1
    r1, r2 = tbn.bn_sums_ref(x)
    jax_dtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                 torch.float16: jnp.float16}[dtype]
    m1, m2 = jax_bn_moments(jnp.asarray(x_nhwc, jax_dtype), method="pallas")
    scale1 = x.float().abs().sum((0, 2, 3))
    for head in (0, vec - 1):
        plan = tbn.sums_plan(n, c, size, head, H100_SMS)
        _check_plan(plan, n, c, size, head)
        s1, s2 = tbn.bn_sums_by_plan(x, plan)
        for want1, want2 in ((r1, r2), (torch.tensor(np.asarray(m1)) * n,
                                        torch.tensor(np.asarray(m2)) * n)):
            assert float(((s1 - want1).abs() / scale1).max()) <= 1e-5
            assert float(((s2 - want2).abs() / r2).max()) <= 1e-5


@pytest.mark.parametrize("shape,dtype,head", [
    ((1, 1, 1, 1), torch.float32, 3),   # (2, 1, 1, 1)[1:]: 4 bytes in
    ((1, 1, 1, 1), torch.bfloat16, 7),  # ... 2 bytes in
    ((1, 3, 1, 1), torch.float16, 7),
    ((0, 1, 1, 1), torch.float32, 3),   # an empty view
    ((0, 5, 3, 3), torch.bfloat16, 0)])
def test_fold_on_inputs_smaller_than_the_head(shape, dtype, head):
    """Inputs of fewer elements than the head or than one super-row: no
    super-row, every element added by the head and tail walks."""
    x = torch.from_numpy(np.random.RandomState(1).normal(
        size=shape).astype(np.float32)).to(dtype).contiguous(
            memory_format=torch.channels_last)
    n, c, size = x.numel() // shape[1], shape[1], x.element_size()
    plan = tbn.sums_plan(n, c, size, head, H100_SMS)
    _check_plan(plan, n, c, size, head)
    assert plan.super_rows == 0
    s1, s2 = tbn.bn_sums_by_plan(x, plan)
    r1, r2 = tbn.bn_sums_ref(x)
    torch.testing.assert_close(s1, r1, rtol=1e-6, atol=0)
    torch.testing.assert_close(s2, r2, rtol=1e-6, atol=0)
