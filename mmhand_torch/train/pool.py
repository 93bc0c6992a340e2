"""Device-resident image replay pool (counterpart of mmhand_tpu/train/pool.py;
reference util/image_pool.py:7-34).

A buffer of up to ``pool_size`` past fakes.  Per query image, while the pool
is filling the image is stored and returned as it is; once the pool is full,
with p = 0.5 a random stored fake is returned and replaced by the new one,
else the new image passes through.

``pool_query`` takes the swap coins and slot ids as tensors and keeps the
JAX package's vectorised form of the reference's sequential per-image loop:
the last writer of a slot wins, and a swapping image gets what its slot held
just before its own write (an earlier writer of this batch, else the buffer).
``pool_query_random`` draws the coins and slots from a ``torch.Generator``.
The buffer is rebuilt with one ``torch.where``, with no host round trip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PoolState(NamedTuple):
    images: torch.Tensor  # (pool_size, H, W, C)
    num: int              # count of stored images


def pool_init(pool_size: int, image_shape, dtype=torch.float32,
              device="cuda") -> PoolState:
    return PoolState(torch.zeros((pool_size, *image_shape), dtype=dtype,
                                 device=device), 0)


def pool_query(state: PoolState, batch: torch.Tensor, coins: torch.Tensor,
               slots: torch.Tensor) -> tuple[PoolState, torch.Tensor]:
    """Query the pool with a batch of fakes.

    Args:
      coins: (B,) uniforms in [0, 1); image i swaps when the pool is full and
        coins[i] > 0.5.
      slots: (B,) int slot ids in [0, pool_size), the slot image i swaps with.
    Returns (new_state, replayed_batch).  A pool_size of 0 passes the batch
    through (reference :15-16).
    """
    pool_size = state.images.shape[0]
    if pool_size == 0:
        return state, batch
    batch = batch.to(state.images.dtype)  # pools in the compute dtype
    bsz = batch.shape[0]
    dev = batch.device
    coins, slots = coins.to(dev), slots.to(device=dev, dtype=torch.long)

    i_idx = torch.arange(bsz, device=dev)
    # image i fills while the pool is not full: num + i < pool_size
    fills = state.num + i_idx < pool_size
    swaps = ~fills & (coins > 0.5)
    writes = fills | swaps
    slot = torch.where(fills, state.num + i_idx, slots)

    # last writer per pool slot (or -1): later images win
    writer_i = torch.where(writes, i_idx, -1)
    onehot = slot[None, :] == torch.arange(pool_size, device=dev)[:, None]
    last_writer = torch.where(onehot, writer_i[None, :], -1).amax(1)
    new_images = torch.where((last_writer >= 0)[:, None, None, None],
                             batch[last_writer.clamp(min=0)], state.images)

    # a swapping image returns what its slot held just before its write: the
    # latest earlier writer to that slot, else the buffer's content
    match = slot[None, :] == slots[:, None]
    earlier = match & (writer_i[None, :] < i_idx[:, None])
    prev_writer = torch.where(earlier, writer_i[None, :], -1).amax(1)
    replayed = torch.where(
        swaps[:, None, None, None],
        torch.where((prev_writer >= 0)[:, None, None, None],
                    batch[prev_writer.clamp(min=0)], state.images[slots]),
        batch)
    return PoolState(new_images, min(state.num + bsz, pool_size)), replayed


def pool_query_random(state: PoolState, batch: torch.Tensor,
                      generator: torch.Generator
                      ) -> tuple[PoolState, torch.Tensor]:
    """``pool_query`` with coins and slots drawn from ``generator``, which
    lies on the batch's device."""
    pool_size = state.images.shape[0]
    if pool_size == 0:
        return state, batch
    bsz, dev = batch.shape[0], batch.device
    coins = torch.rand(bsz, generator=generator, device=dev)
    slots = torch.randint(0, pool_size, (bsz,), generator=generator,
                          device=dev)
    return pool_query(state, batch, coins, slots)
