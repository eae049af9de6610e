"""k-space ops of the port (counterpart of mvtb_tpu/ops): centered FFTs,
masks, the per-volume corruption ops and the fused stylization.

Every op is ``f(x, params[, generator]) -> x_hat`` on channel-first tensors
with the trailing ``n_dims`` axes spatial, on the device of ``x``.
"""

from mvtb_tpu_torch.ops.fourier import fft_shifted, ifft_shifted, ifft_shifted_real
from mvtb_tpu_torch.ops.masks import (
    disk_mask,
    ellipsoid_shell_mask,
    gibbs_mask,
    reference_gibbs_layer_mask,
    sample_ellipsoid,
    soft_gibbs_mask,
)
from mvtb_tpu_torch.ops.corruptions import (
    default_spike_intensity_stats,
    fourier_disk_filter,
    gibbs_noise,
    kspace_spike,
    kspace_spike_random,
    plane_wave,
    rand_zero_fill,
    salt_and_pepper,
    wrap_artifact,
)
from mvtb_tpu_torch.ops.fused import (StageDraws, StylizeConfig, sample_draws,
                                      stylize_batch, stylize_kspace)

__all__ = [
    "fft_shifted",
    "ifft_shifted",
    "ifft_shifted_real",
    "disk_mask",
    "gibbs_mask",
    "soft_gibbs_mask",
    "reference_gibbs_layer_mask",
    "ellipsoid_shell_mask",
    "sample_ellipsoid",
    "fourier_disk_filter",
    "gibbs_noise",
    "kspace_spike",
    "kspace_spike_random",
    "default_spike_intensity_stats",
    "plane_wave",
    "wrap_artifact",
    "salt_and_pepper",
    "rand_zero_fill",
    "stylize_kspace",
    "stylize_batch",
    "StylizeConfig",
    "StageDraws",
    "sample_draws",
]
