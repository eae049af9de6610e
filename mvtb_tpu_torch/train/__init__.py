"""Training and evaluation steps of the port (counterpart of mvtb_tpu/train)."""

from mvtb_tpu_torch.train.checkpoint import CheckpointManager
from mvtb_tpu_torch.train.chunked import make_chunk_fn, train_chunked
from mvtb_tpu_torch.train.losses import bce_with_logits, dice_loss, mse
from mvtb_tpu_torch.train.seg import (EpochMetrics, ReferenceAmsgrad, SegState,
                                      create_seg_state, reference_optimizer,
                                      seg_eval_step, seg_train_step,
                                      train_segmentation)

__all__ = ["CheckpointManager", "EpochMetrics", "ReferenceAmsgrad", "SegState",
           "bce_with_logits", "create_seg_state", "dice_loss", "make_chunk_fn", "mse",
           "reference_optimizer", "seg_eval_step", "seg_train_step",
           "train_chunked", "train_segmentation"]
