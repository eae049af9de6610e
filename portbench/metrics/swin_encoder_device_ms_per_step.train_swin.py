"""Device milliseconds a training step spends in SwinUNETR's Swin encoder:
the traced records launched inside the port's ``mvtb.swin.encoder`` span
(patch embedding through the fifth encoder output, window layout and
attention included), over the traced ``mvtb.step`` spans. Spans cannot see
the backward, which autograd runs on its own thread: this is the
forward's device time."""

from portbench import spans


def read(record):
    trace = record.get("trace")
    steps = spans.count(trace, "mvtb.step")
    if not steps or not spans.count(trace, "mvtb.swin.encoder"):
        return None
    return spans.device_ms_under(trace, "mvtb.swin.encoder") / steps
