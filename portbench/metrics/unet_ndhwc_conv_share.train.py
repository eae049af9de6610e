"""The share of the UNet's convolution calls that ran channels-last
(NDHWC), cuDNN's tensor-core form on the card, from the port's counters
over the whole run: ``unet.convs_ndhwc`` over ``unet.convs``, in %. None
where the port counts no UNet convolutions."""

from portbench import spans


def read(record):
    c = spans.program_counters()
    if not c.get("unet.convs"):
        return None
    return 100.0 * c.get("unet.convs_ndhwc", 0) / c["unet.convs"]
