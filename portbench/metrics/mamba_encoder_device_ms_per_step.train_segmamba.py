"""Device milliseconds a training step spends in SegMamba's encoder: the
traced records launched inside the port's ``mvtb.mamba.encoder`` span (the
stem through the four stages' MLP outputs, GSC, layout and scans
included), over the traced ``mvtb.step`` spans. Spans cannot see the
backward, which autograd runs on its own thread: this is the forward's
device time."""

from portbench import spans


def read(record):
    trace = record.get("trace")
    steps = spans.count(trace, "mvtb.step")
    if not steps or not spans.count(trace, "mvtb.mamba.encoder"):
        return None
    return spans.device_ms_under(trace, "mvtb.mamba.encoder") / steps
