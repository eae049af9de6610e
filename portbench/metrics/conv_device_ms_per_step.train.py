"""Device milliseconds a training step spends in the UNet's convolutions:
the traced kernels launched under ``aten::convolution`` or
``aten::convolution_backward``, over the traced steps."""

CONV_OPS = ("aten::convolution", "aten::convolution_backward")


def read(record):
    trace = record.get("trace")
    if not trace or not trace.get("steps"):
        return None
    us = sum(e["dur"] for e in trace["device"] if any(o in CONV_OPS for o in e["ops"]))
    if us == 0:
        return None
    return 1e-3 * us / trace["steps"]
