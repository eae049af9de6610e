"""Evaluation of the port (counterpart of mvtb_tpu/eval): Dice, the
evaluation and sweep harness, sliding-window inference, FID and plots."""

from mvtb_tpu_torch.eval.dice import dice_metric, dice_scores, threshold_predictions
from mvtb_tpu_torch.eval.fid import (FrozenFeatureEncoder, dcgan_fid, discriminator_features,
                                     feature_statistics, fid_score, frechet_distance)
from mvtb_tpu_torch.eval.harness import ModelEvaluation, TransformSweep
from mvtb_tpu_torch.eval.sliding_window import (make_sliding_window_fn,
                                                sliding_window_inference)

__all__ = ["FrozenFeatureEncoder", "ModelEvaluation", "TransformSweep", "dcgan_fid",
           "dice_metric", "dice_scores", "discriminator_features", "feature_statistics",
           "fid_score", "frechet_distance", "make_sliding_window_fn",
           "sliding_window_inference", "threshold_predictions"]
