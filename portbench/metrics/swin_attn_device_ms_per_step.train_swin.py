"""Device milliseconds a training step spends in SwinUNETR's window
attention: the traced records launched inside the port's
``mvtb.swin.attn`` spans (the attention call alone, between ``qkv`` and
``proj``), over the traced ``mvtb.step`` spans. Spans cannot see the
backward, which autograd runs on its own thread: this is the forward's
device time."""

from portbench import spans


def read(record):
    trace = record.get("trace")
    steps = spans.count(trace, "mvtb.step")
    if not steps or not spans.count(trace, "mvtb.swin.attn"):
        return None
    return spans.device_ms_under(trace, "mvtb.swin.attn") / steps
