"""Collectives of data-parallel training over ``torch.distributed``
(counterpart of mmhand_tpu/parallel/sharding.py; reference
models/MMHandModel.py:99-116, APEX DDP over NCCL).

The parameters, optimizer states and running statistics are replicated:
every rank holds them whole and applies the same averaged gradients.  The
batch is split over the ranks, and each rank keeps its own image pools, as
the reference's per-rank ImagePool instances and mmhand_tpu's per-replica
pools.

* ``all_reduce_sum``: a differentiable sum over ranks (forward sums,
  backward sums), which the train-mode BatchNorm uses for its moments;
* ``all_reduce_grads``: each network's gradients averaged over the ranks in
  one flat bucket, the counterpart of ``pmean`` of the gradients;
* ``any_rank``: the OR-vote of a flag (the reference's overflow vote);
* ``mean_metrics``: the step's metrics averaged in one stacked call;
* ``gather_ranks``: per-rank tensors stacked into one (world, ...) tensor on
  every rank, for the checkpoint.

Every collective is an all-reduce, which NCCL and gloo both take on CUDA
tensors.  Each function counts the all-reduces it issues in ``.launches``.
The nets are not wrapped in ``DistributedDataParallel``: the G phase turns
the discriminators' gradients off and, at DG_ratio 2, each discriminator
runs two backwards per step, neither of which DDP's reducer expects.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.contiguous().clone()
        dist.all_reduce(out)
        all_reduce_sum.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        all_reduce_sum.launches += 1
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks; its gradient is the sum over the
    ranks of the output's gradients."""
    return _AllReduceSum.apply(x)


def flat_grads(params: list[torch.Tensor]) -> torch.Tensor:
    """The gradients of ``params`` in one flat f32 buffer, in order; a
    parameter with no gradient raises."""
    missing = [i for i, p in enumerate(params) if p.grad is None]
    if missing:
        raise RuntimeError(f"parameters {missing[:8]} have no gradient: a net "
                           f"of this step left some of its parameters unused")
    return torch.cat([p.grad.reshape(-1).float() for p in params])


def set_grads_(params: list[torch.Tensor], flat: torch.Tensor) -> None:
    """Copy ``flat`` (as ``flat_grads`` laid it out) back into the
    gradients."""
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view(p.shape))
        offset += n


def all_reduce_mean_(flat: torch.Tensor) -> torch.Tensor:
    """``flat`` averaged over the ranks, in place."""
    dist.all_reduce(flat)
    all_reduce_mean_.launches += 1
    return flat.div_(dist.get_world_size())


def all_reduce_grads(module: torch.nn.Module) -> None:
    """Average the gradients of ``module``'s trainable parameters over the
    ranks, one all-reduce for the whole net."""
    params = [p for p in module.parameters() if p.requires_grad]
    flat = flat_grads(params)
    all_reduce_mean_(flat)
    set_grads_(params, flat)


def any_rank(flag: torch.Tensor) -> torch.Tensor:
    """True on every rank iff ``flag`` (0-d bool) is True on one."""
    votes = flag.to(torch.int32)
    dist.all_reduce(votes, op=dist.ReduceOp.MAX)
    any_rank.launches += 1
    return votes > 0


def mean_metrics(metrics: dict) -> dict:
    """The 0-d metrics averaged over the ranks in one all-reduce."""
    keys = list(metrics)
    stacked = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(stacked)
    mean_metrics.launches += 1
    stacked = stacked / dist.get_world_size()
    return dict(zip(keys, stacked.unbind()))


def gather_ranks(x: torch.Tensor) -> torch.Tensor:
    """(world, *x.shape): every rank's ``x``, on every rank.  Written as an
    all-reduce of a zero buffer that holds ``x`` at this rank's row, which is
    exact (x + 0 == x), and which gloo takes on CUDA tensors, where it has no
    all-gather."""
    out = torch.zeros((dist.get_world_size(), *x.shape), dtype=x.dtype,
                      device=x.device)
    out[dist.get_rank()] = x
    dist.all_reduce(out)
    gather_ranks.launches += 1
    return out


COLLECTIVES = (all_reduce_sum, all_reduce_mean_, any_rank, mean_metrics,
               gather_ranks)
for _f in COLLECTIVES:
    _f.launches = 0


def collective_launches() -> int:
    """All-reduces issued so far by the functions of this module."""
    return sum(f.launches for f in COLLECTIVES)
