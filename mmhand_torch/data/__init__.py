from mmhand_torch.data.annotations import load_annotations, split_src_tgt
from mmhand_torch.data.datasets import (
    RHDCrops,
    STBCrops,
    SyntheticHands,
    build_dataset,
)
from mmhand_torch.data.loader import HostLoader, make_prepare_batch

__all__ = [
    "load_annotations", "split_src_tgt",
    "RHDCrops", "STBCrops", "SyntheticHands", "build_dataset",
    "HostLoader", "make_prepare_batch",
]
