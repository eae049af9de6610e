"""Device milliseconds a training step spends in SwinUNETR's window
layout: the traced records launched inside the port's ``mvtb.swin.window``
spans (pad, roll, partition and the additive bias-and-mask tensor's
assembly before the attention; reverse, roll back and crop after it; the
index and mask build when its cache misses), over the traced
``mvtb.step`` spans. Spans cannot see the backward, which autograd runs on
its own thread: this is the forward's device time."""

from portbench import spans


def read(record):
    trace = record.get("trace")
    steps = spans.count(trace, "mvtb.step")
    if not steps or not spans.count(trace, "mvtb.swin.window"):
        return None
    return spans.device_ms_under(trace, "mvtb.swin.window") / steps
