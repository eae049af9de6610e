"""Evaluation of the port (counterpart of mvtb_tpu/eval)."""

from mvtb_tpu_torch.eval.dice import dice_metric, dice_scores, threshold_predictions

__all__ = ["dice_metric", "dice_scores", "threshold_predictions"]
