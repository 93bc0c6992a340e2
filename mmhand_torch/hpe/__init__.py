from mmhand_torch.hpe.data import HPEMixDataset, make_hpe_prepare_batch
from mmhand_torch.hpe.system import HPESystem, make_hpe_train_step

__all__ = ["HPESystem", "make_hpe_train_step",
           "HPEMixDataset", "make_hpe_prepare_batch"]
