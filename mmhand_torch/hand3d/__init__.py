"""The hand3d (ColorHandPose3D) trainer and its sample pipeline
(counterpart of mmhand_tpu/hand3d)."""

from mmhand_torch.hand3d.pipeline import PipelineConfig, derive_batch
from mmhand_torch.hand3d.system import (
    TRAIN_PARA_HANDSEGNET,
    TRAIN_PARA_LIFTING,
    TRAIN_PARA_POSENET,
    Hand3DSystem,
    load_color_hand_pose,
    make_hand3d_train_step,
    staged_lr,
)

__all__ = ["Hand3DSystem", "PipelineConfig", "TRAIN_PARA_HANDSEGNET",
           "TRAIN_PARA_LIFTING", "TRAIN_PARA_POSENET", "derive_batch",
           "load_color_hand_pose", "make_hand3d_train_step", "staged_lr"]
