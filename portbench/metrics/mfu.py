"""The window's share of the configured peak: the operations of every
volume done in the window (``counters["flops_per_volume"]``, which the
cell's driver counts: the UNet's forward and backward in training
(``portbench/flops.py``), its forward over every sliding-window tile in
evaluation, a forward and an inverse 3D transform a channel in
stylization), over the window's seconds, against the published dense peak
of the precision the driver names (``counters["peak"]``)."""

from portbench.roofline import PEAK_FLOPS


def read(record):
    c = record["counters"]
    if not c.get("volumes") or not record.get("window_s"):
        return None
    return 100.0 * c["volumes"] * c["flops_per_volume"] / record["window_s"] / PEAK_FLOPS[c["peak"]]
