"""Reference-compatible transform API (MONAI-style array + dict transforms),
counterpart of mvtb_tpu/transforms."""

from mvtb_tpu_torch.transforms.base import (
    Compose,
    KeysCollection,
    MapTransform,
    Randomizable,
    RandomizableTransform,
    ReCompose,
    Transform,
    ensure_tuple,
)
from mvtb_tpu_torch.transforms.array import (
    GibbsNoise,
    KSpaceSpikeNoise,
    RandGibbsNoise,
    RandKSpaceSpikeNoise,
    RandZF,
    WrapArtifact,
)
from mvtb_tpu_torch.transforms.dictionary import (
    ConvertToMultiChannelBasedOnBratsClassesd,
    MultimodalSlicesd,
    RandFourierDiskMaskd,
    RandGibbsNoised,
    RandKSpaceSpikeNoised,
    RandPlaneWaves_ellipsoid,
    SaltAndPepper,
    SegmentationSlicesd,
    SelectChanneld,
    WholeTumorTCGA,
    WrapArtifactd,
)

__all__ = [
    "Compose", "KeysCollection", "MapTransform", "Randomizable",
    "RandomizableTransform", "ReCompose", "Transform", "ensure_tuple",
    "GibbsNoise", "KSpaceSpikeNoise", "RandGibbsNoise", "RandKSpaceSpikeNoise",
    "RandZF", "WrapArtifact",
    "ConvertToMultiChannelBasedOnBratsClassesd", "MultimodalSlicesd",
    "RandFourierDiskMaskd",
    "RandGibbsNoised", "RandKSpaceSpikeNoised", "RandPlaneWaves_ellipsoid",
    "SaltAndPepper", "SegmentationSlicesd", "SelectChanneld", "WholeTumorTCGA",
    "WrapArtifactd",
]
