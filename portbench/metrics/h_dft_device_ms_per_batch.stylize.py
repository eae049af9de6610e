"""Device milliseconds a stylized batch spends in the plane path's H-axis
half DFT and its inverse: the traced records launched inside the port's
``mvtb.stylize.h_dft`` spans, over the traced ``mvtb.stylize_batch``
spans."""

from portbench import spans


def read(record):
    trace = record.get("trace")
    batches = spans.count(trace, "mvtb.stylize_batch")
    if not batches or not spans.count(trace, "mvtb.stylize.h_dft"):
        return None
    return spans.device_ms_under(trace, "mvtb.stylize.h_dft") / batches
