"""Training and evaluation steps of the port (counterpart of mvtb_tpu/train)."""

from mvtb_tpu_torch.train.seg import EpochMetrics, seg_eval_step

__all__ = ["EpochMetrics", "seg_eval_step"]
