"""Data of the port (counterpart of mvtb_tpu/data): the synthetic
generators and the host -> device prefetch."""

from mvtb_tpu_torch.data.prefetch import device_prefetch
from mvtb_tpu_torch.data.synthetic import (batches, cached_batches,
                                           decathlon_style_dicts, generate_pool,
                                           make_textured_volume, make_volume,
                                           onehot_to_brats_ids)

__all__ = ["batches", "cached_batches", "decathlon_style_dicts", "device_prefetch",
           "generate_pool", "make_textured_volume", "make_volume",
           "onehot_to_brats_ids"]
