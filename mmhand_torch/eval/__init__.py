from mmhand_torch.eval.evaluator import Evaluator, HPEJudge
from mmhand_torch.eval.metrics import (
    EvalUtil,
    fid_from_features,
    inception_score_from_logits,
)

__all__ = ["EvalUtil", "inception_score_from_logits", "fid_from_features",
           "Evaluator", "HPEJudge"]
