"""Data-parallel training over torch.distributed (counterpart of
mmhand_tpu/parallel)."""

from mmhand_torch.parallel.mesh import init_distributed
from mmhand_torch.parallel.sharding import all_reduce_grads, all_reduce_sum

__all__ = ["all_reduce_grads", "all_reduce_sum", "init_distributed"]
