"""Training and evaluation steps of the port (counterpart of mvtb_tpu/train)."""

from mvtb_tpu_torch.train.checkpoint import CheckpointManager
from mvtb_tpu_torch.train.chunked import (DCGAN_CURVES, RECON_CURVES, make_chunk_fn,
                                          make_dcgan_chunk_fn, make_learnable_chunk_fn,
                                          make_recon_gan_chunk_fn, train_chunked)
from mvtb_tpu_torch.train.gan import (GANState, create_gan_state, dcgan_step,
                                      gan_optimizer, recon_gan_step, sample_recon_draws)
from mvtb_tpu_torch.train.learnable import (create_learnable_state, fd_train_step,
                                            learnable_train_step, styl_param)
from mvtb_tpu_torch.train.losses import bce_with_logits, dice_loss, mse
from mvtb_tpu_torch.train.seg import (EpochMetrics, ReferenceAmsgrad, SegState,
                                      create_seg_state, reference_optimizer,
                                      seg_eval_step, seg_train_step,
                                      train_segmentation)

__all__ = ["CheckpointManager", "DCGAN_CURVES", "EpochMetrics", "GANState", "RECON_CURVES",
           "ReferenceAmsgrad", "SegState", "bce_with_logits", "create_gan_state",
           "create_learnable_state", "create_seg_state", "dcgan_step", "dice_loss",
           "fd_train_step", "gan_optimizer", "learnable_train_step", "make_chunk_fn",
           "make_dcgan_chunk_fn", "make_learnable_chunk_fn", "make_recon_gan_chunk_fn", "mse",
           "recon_gan_step", "reference_optimizer", "sample_recon_draws", "seg_eval_step",
           "seg_train_step", "styl_param", "train_chunked", "train_segmentation"]
