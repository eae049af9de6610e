"""k-space ops of the port (counterpart of mvtb_tpu/ops)."""

from mvtb_tpu_torch.ops.fused import (StageDraws, StylizeConfig, sample_draws,
                                      stylize_batch, stylize_kspace)

__all__ = ["StageDraws", "StylizeConfig", "sample_draws", "stylize_batch",
           "stylize_kspace"]
