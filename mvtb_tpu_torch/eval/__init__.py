"""Evaluation of the port (counterpart of mvtb_tpu/eval)."""

from mvtb_tpu_torch.eval.dice import dice_metric, dice_scores, threshold_predictions
from mvtb_tpu_torch.eval.fid import (FrozenFeatureEncoder, dcgan_fid, discriminator_features,
                                     feature_statistics, fid_score, frechet_distance)

__all__ = ["FrozenFeatureEncoder", "dcgan_fid", "dice_metric", "dice_scores",
           "discriminator_features", "feature_statistics", "fid_score", "frechet_distance",
           "threshold_predictions"]
