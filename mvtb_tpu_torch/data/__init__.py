"""Data of the port (counterpart of mvtb_tpu/data): the synthetic
generators and trees, NIfTI ingest, MONAI-equivalent preprocessing, the
loaders, the hospital domains and the host -> device prefetch."""

from mvtb_tpu_torch.data.synthetic import (batches, build_decathlon_tree, build_tcga_tree,
                                           cached_batches, decathlon_style_dicts,
                                           generate_pool, make_textured_volume, make_volume,
                                           onehot_to_brats_ids)
from mvtb_tpu_torch.data.pipeline import (Loader, StylizedLoader, brats_train_pipeline,
                                          brats_val_pipeline)
from mvtb_tpu_torch.data.nifti import (DecathlonDataset, read_nifti, reference_val_split,
                                       tcga_manifest_datasets, write_nifti)
from mvtb_tpu_torch.data.brats_sweep import BratsValIterDataset
from mvtb_tpu_torch.data.prefetch import device_prefetch
from mvtb_tpu_torch.data.slices import RandConcatd, Sliced
from mvtb_tpu_torch.data.tcga import (domain_loaders, generalization_gap, partition_dataset,
                                      synthetic_hospital_samples, tcga_train_pipeline,
                                      tcga_val_pipeline, textured_hospital_samples)

__all__ = [
    "batches", "build_decathlon_tree", "build_tcga_tree", "cached_batches",
    "decathlon_style_dicts", "generate_pool", "make_textured_volume", "make_volume",
    "onehot_to_brats_ids",
    "BratsValIterDataset", "device_prefetch",
    "Loader", "StylizedLoader", "brats_train_pipeline", "brats_val_pipeline",
    "DecathlonDataset", "read_nifti", "reference_val_split", "tcga_manifest_datasets",
    "write_nifti",
    "RandConcatd", "Sliced",
    "domain_loaders", "generalization_gap", "partition_dataset",
    "synthetic_hospital_samples", "tcga_train_pipeline", "tcga_val_pipeline",
    "textured_hospital_samples",
]
